"""The multi-device runners of the port, on `torch.distributed`: the
frame-batch runner (`batch`), the spatial runner over B' row slabs and
the 2-D bands x slabs mesh (`spatial`), the band-sharded A runner
(`sharded_a`), their meshes and launcher (`mesh`), the collective model
(`comms`) and the mesh-shape planner (`plan2d`)."""
