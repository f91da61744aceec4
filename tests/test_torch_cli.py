"""The port's command line on the CPU (`--device cpu`), as a user drives
it: the cases of tests/test_cli.py for `examples`, `synth` (progress
stream, checkpoints and a bit-identical resume; brute with kappa), the
`batch` flags and a bad matcher refused at parse time; and beside them:
the brute PNG against the JAX CLI's on the same assets (uint8 arrays
equal except at rounding boundaries), the PatchMatch PNG against the
port's library call bit for bit, `video` writing one frame per input
and naming each in its progress stream, the telemetry directory, a
supervised run healing a fault, the flags of unported parts
stopping the run with their ROADMAP step, and the step-12 flags
(`--health`, `--metrics-port`) running, the health epilogue on every
runner; `serve --device cpu` in its own process answering a request,
draining on SIGTERM and exiting 0, `trace --trace-dir` reconstructing
that request within 5 %, and serve's and trace's unported flags
stopping at startup."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from image_analogies_tpu import cli as j_cli
from image_analogies_tpu_torch import SynthConfig, cli, create_image_analogy
from image_analogies_tpu_torch.runtime import faults
from image_analogies_tpu_torch.utils.io import load_image, to_uint8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(argv):
    return cli.main(argv)


def _png(path):
    return np.asarray(Image.open(path))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli_assets"))
    assert _run(["examples", "--out", d, "--size", "64"]) == 0
    return d


def _synth(assets, family="texture_by_numbers"):
    return [
        "synth",
        "--a", os.path.join(assets, f"{family}_A.png"),
        "--ap", os.path.join(assets, f"{family}_Ap.png"),
        "--b", os.path.join(assets, f"{family}_B.png"),
        "--device", "cpu",
    ]


def test_examples_writes_all_families(assets):
    names = os.listdir(assets)
    for family in ("texture_by_numbers", "artistic_filter",
                   "super_resolution", "texture_transfer", "npr"):
        assert any(family in n for n in names), (family, names)
    assert len(names) == 4 * 3 + 2 + 4


def test_synth_end_to_end_with_progress_and_resume(assets, tmp_path):
    out1, out2 = str(tmp_path / "bp1.png"), str(tmp_path / "bp2.png")
    prog = str(tmp_path / "run.jsonl")
    ckpt = str(tmp_path / "ckpt")
    base = _synth(assets) + ["--levels", "2", "--matcher", "patchmatch",
                             "--em-iters", "1"]
    _run(base + ["--out", out1, "--progress", prog,
                 "--save-level-artifacts", ckpt])
    img1 = _png(out1)
    assert img1.shape[-1] == 3 and img1.std() > 5.0
    events = [json.loads(ln)["event"] for ln in open(prog)]
    assert events.count("level_done") == 2
    assert events[0] == "start" and events[-1] == "done"
    assert sorted(os.listdir(ckpt)) == ["level_0.npz", "level_1.npz"]
    _run(base + ["--out", out2, "--resume-from", ckpt])
    np.testing.assert_array_equal(_png(out2), img1)


def test_synth_brute_oracle_and_knob_passthrough(assets, tmp_path):
    out = str(tmp_path / "bp.png")
    _run(_synth(assets) + ["--out", out, "--levels", "1", "--matcher",
                           "brute", "--em-iters", "1", "--kappa", "2.0"])
    assert os.path.exists(out)


def test_batch_runner_flags(assets, tmp_path):
    frames, outdir = str(tmp_path / "frames"), str(tmp_path / "styled")
    os.makedirs(frames)
    b = Image.open(os.path.join(assets, "npr_frame_0.png"))
    for i in range(2):
        b.save(os.path.join(frames, f"f{i:03d}.png"))
    _run(["batch", "--a", os.path.join(assets, "npr_A.png"),
          "--ap", os.path.join(assets, "npr_Ap.png"), "--frames", frames,
          "--out", outdir, "--levels", "2", "--em-iters", "1",
          "--frames-per-step", "1", "--device", "cpu"])
    assert sorted(os.listdir(outdir)) == ["f000.png", "f001.png"]
    assert _png(os.path.join(outdir, "f000.png")).shape == (64, 64, 3)


def test_bad_matcher_rejected_at_parse_time(tmp_path):
    with pytest.raises(SystemExit) as exc:
        _run(["synth", "--matcher", "nonsense", "--a", "x", "--ap", "x",
              "--b", "x", "--out", str(tmp_path / "o.png")])
    assert exc.value.code not in (0, None)


def test_brute_png_matches_the_jax_cli(assets, tmp_path):
    """The same assets through both command lines, brute (no random
    draws): at most 0.1 % of the uint8 values differ.  Most differences
    are rounding boundaries (1); a larger one lies only where the two
    converged fields differ, and on the coarsest level, which both
    packages start from the same inputs, every differing pick is a
    near-tie of the exact distances: the expansion ||a||^2 - 2 a.b both
    packages minimize flips near-tied picks (ROADMAP Queue 3), and the
    8-bit inputs make such ties common."""
    from image_analogies_tpu import SynthConfig as JCfg
    from image_analogies_tpu import create_image_analogy as j_create

    kw = dict(matcher="brute", levels=2, em_iters=1)
    args = _synth(assets)[:-2] + ["--matcher", "brute", "--levels", "2",
                                  "--em-iters", "1", "--device", "cpu"]
    j_out, t_out = str(tmp_path / "jax.png"), str(tmp_path / "torch.png")
    j_cli.main(args + ["--out", j_out])
    _run(args + ["--out", t_out])
    j, t = _png(j_out).astype(np.int16), _png(t_out).astype(np.int16)
    assert j.shape == t.shape
    diff = np.abs(j - t)
    assert (diff > 0).mean() <= 1e-3

    imgs = [load_image(os.path.join(assets, f"texture_by_numbers_{x}.png"))
            for x in ("A", "Ap", "B")]
    ja = j_create(*imgs, JCfg(**kw), return_aux=True)
    ta = create_image_analogy(*imgs, SynthConfig(device="cpu", **kw),
                              return_aux=True)
    np.testing.assert_array_equal(to_uint8(ta["bp"]), t)
    np.testing.assert_array_equal(to_uint8(np.asarray(ja["bp"])), j)
    moved = np.any(np.asarray(ja["nnf"][0]) != ta["nnf"][0].numpy(), -1)
    assert not (np.any(diff > 1, -1) & ~moved).any()
    coarse = np.any(np.asarray(ja["nnf"][1]) != ta["nnf"][1].numpy(), -1)
    assert coarse.mean() <= 1e-2  # 3 of the 1,024 coarse pixels
    jd, td = np.asarray(ja["dist"][1])[coarse], ta["dist"][1].numpy()[coarse]
    assert (np.abs(jd - td) <= 1e-3 * jd).all()


def test_patchmatch_png_equals_the_library_call(assets, tmp_path):
    """The CLI's PatchMatch output is the library's B' for the loaded
    inputs, the same config and seed, bit for bit."""
    out = str(tmp_path / "bp.png")
    _run(_synth(assets, "super_resolution") + [
        "--out", out, "--levels", "2", "--em-iters", "2", "--pm-iters",
        "3", "--seed", "7", "--trace-dir", str(tmp_path / "td")])
    imgs = [load_image(os.path.join(assets, f"super_resolution_{t}.png"))
            for t in ("A", "Ap", "B")]
    lib = create_image_analogy(*imgs, SynthConfig(
        device="cpu", levels=2, em_iters=2, pm_iters=3, seed=7))
    np.testing.assert_array_equal(_png(out), to_uint8(lib))


def test_trace_dir_artifacts(assets, tmp_path):
    td = str(tmp_path / "td")
    _run(_synth(assets) + ["--out", str(tmp_path / "bp.png"), "--levels",
                           "2", "--em-iters", "2", "--trace-dir", td])
    assert sorted(os.listdir(td)) == ["flight.json", "host_spans.json",
                                      "metrics.json", "metrics.prom"]
    spans = json.load(open(os.path.join(td, "host_spans.json")))
    names = [s["name"] for s in spans["spans"]]
    assert names == ["start", "run", "done"]
    levels = [s for s in spans["spans"][1]["children"]
              if s["name"] == "level"]
    assert [len(s["children"]) for s in levels] == [2, 2]
    metrics = json.load(open(os.path.join(td, "metrics.json")))
    assert metrics["ia_levels_total"]["values"] == {"total": 2.0}
    assert metrics["ia_em_iters_total"]["values"] == {"total": 4.0}
    assert json.load(open(os.path.join(td, "flight.json")))[
        "flushed_on"] == "session-end"


def test_video_writes_every_frame_and_names_it(assets, tmp_path):
    frames, outdir = str(tmp_path / "frames"), str(tmp_path / "styled")
    prog = str(tmp_path / "video.jsonl")
    os.makedirs(frames)
    for i in range(3):
        Image.open(os.path.join(assets, f"npr_frame_{i}.png")).save(
            os.path.join(frames, f"t{i:02d}.png"))
    _run(["video", "--a", os.path.join(assets, "npr_A.png"),
          "--ap", os.path.join(assets, "npr_Ap.png"), "--frames", frames,
          "--out", outdir, "--levels", "2", "--em-iters", "1",
          "--pm-iters", "2", "--tau", "0.1", "--progress", prog,
          "--device", "cpu"])
    assert sorted(os.listdir(outdir)) == ["t00.png", "t01.png", "t02.png"]
    recs = [json.loads(ln) for ln in open(prog)]
    assert [r["name"] for r in recs if r["event"] == "frame"] == [
        "t00.png", "t01.png", "t02.png"]
    # Three frames of two levels each.
    assert sum(r["event"] == "level_done" for r in recs) == 6


def test_supervised_synth_heals_an_injected_fault(assets, tmp_path):
    out_ok, out_sup = str(tmp_path / "ok.png"), str(tmp_path / "sup.png")
    base = _synth(assets) + ["--levels", "2", "--em-iters", "1"]
    _run(base + ["--out", out_ok])
    faults.set_fault_plan("level:0:raise")
    try:
        _run(base + ["--out", out_sup, "--supervise", "--trace-dir",
                     str(tmp_path / "td")])
    finally:
        faults.set_fault_plan(None)
    np.testing.assert_array_equal(_png(out_sup), _png(out_ok))
    metrics = json.load(open(tmp_path / "td" / "metrics.json"))
    assert metrics["ia_supervisor_attempts_total"]["values"] == {
        "total": 2.0}


@pytest.mark.parametrize("flags,step", [
    (["--spatial"], "step 14"),
    (["--sharded-a"], "step 14"),
    (["--bands", "2"], "step 14"),
    (["--n-devices", "2"], "step 14"),
])
def test_unported_flags_stop_with_their_step(assets, tmp_path, flags, step):
    with pytest.raises(SystemExit) as exc:
        _run(_synth(assets) + ["--out", str(tmp_path / "o.png")] + flags)
    assert exc.value.code not in (0, None)
    assert "not ported" in str(exc.value.code)
    assert step in str(exc.value.code)
    assert not os.path.exists(tmp_path / "o.png")


@pytest.mark.parametrize("flags,artifact", [
    (["--health"], "health.json"),
    (["--metrics-port", "0"], "live.json"),
])
def test_step12_flags_now_run(assets, tmp_path, capsys, flags, artifact):
    """The run sentinel and the live exporter (ROADMAP Queue 1 step 12)
    run: the synthesis writes its output and the flag its artifact."""
    td = tmp_path / "td"
    assert _run(_synth(assets) + [
        "--out", str(tmp_path / "o.png"), "--levels", "1", "--em-iters",
        "1", "--trace-dir", str(td)] + flags) == 0
    assert os.path.exists(tmp_path / "o.png")
    assert (td / artifact).exists()
    if artifact == "health.json":
        assert "health: OK" in capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["synth", "batch", "video"])
def test_health_epilogue_on_every_runner(assets, tmp_path, capsys, cmd):
    """`--health` grades synth, batch and video runs; without a trace
    directory it prints the verdict and writes nothing."""
    if cmd == "synth":
        argv = _synth(assets) + ["--out", str(tmp_path / "o.png")]
    else:
        frames = tmp_path / "frames"
        frames.mkdir()
        b = load_image(os.path.join(assets, "texture_by_numbers_B.png"))
        for i in range(2):
            Image.fromarray(to_uint8(b)).save(frames / f"t{i:02d}.png")
        argv = [cmd, "--a", os.path.join(assets, "texture_by_numbers_A.png"),
                "--ap", os.path.join(assets, "texture_by_numbers_Ap.png"),
                "--frames", str(frames), "--out", str(tmp_path / "out"),
                "--device", "cpu"]
    assert _run(argv + ["--levels", "1", "--em-iters", "1", "--health"]) == 0
    out = capsys.readouterr().out
    assert "health: OK" in out
    assert "span_tree" in out
    assert not os.path.exists(tmp_path / "health.json")


@pytest.mark.parametrize("flags,step", [
    (["--lattice", "on"], "step 13b"),
    (["--warm-dir", "w"], "step 13b"),
    (["--archive-dir", "a"], "step 13b"),
    (["--archive-interval-s", "5"], "step 13b"),
    (["--n-devices", "2"], "step 14"),
])
def test_serve_unported_flags_stop_with_their_step(assets, flags, step):
    with pytest.raises(SystemExit) as exc:
        _run(["serve", "--a", os.path.join(assets, "npr_A.png"),
              "--ap", os.path.join(assets, "npr_Ap.png"),
              "--device", "cpu"] + flags)
    assert "not ported" in str(exc.value.code)
    assert step in str(exc.value.code)


def test_trace_fleet_stops_with_its_step():
    with pytest.raises(SystemExit, match="step 13b"):
        _run(["trace", "r1", "--fleet", "discovery.json"])


def test_serve_without_a_card_refuses(assets, monkeypatch):
    """`serve` runs on cuda by default: without a card it stops at
    startup, before binding, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        _run(["serve", "--a", os.path.join(assets, "npr_A.png"),
              "--ap", os.path.join(assets, "npr_Ap.png")])


def _serve_post(url, frame, rid):
    import base64
    import urllib.request

    body = json.dumps({
        "image_b64": base64.b64encode(frame.tobytes()).decode(),
        "shape": list(frame.shape), "dtype": "uint8",
    }).encode()
    req = urllib.request.Request(url + "/synthesize", data=body,
                                 method="POST",
                                 headers={"X-Request-Id": rid})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def test_serve_subprocess_answers_drains_and_traces(assets, tmp_path):
    """`serve --device cpu` in its own process on 48^2 frames: announce
    after warmup, one uint8 request answered (a warmup hit), SIGTERM
    drains and exits 0 with a drain flight dump; then `trace
    --trace-dir` reconstructs the request within 5 %."""
    import signal
    import time

    td, sd = tmp_path / "td", tmp_path / "sd"
    warm = tmp_path / "warm.json"
    warm.write_text(json.dumps({
        "schema_version": 1, "kind": "serve_warmup",
        "entries": [{"height": 48, "width": 48}]}))
    frame = to_uint8(load_image(os.path.join(assets, "npr_frame_0.png")))
    frame = np.ascontiguousarray(frame[:48, :48])
    proc = subprocess.Popen(
        [sys.executable, "-m", "image_analogies_tpu_torch.cli", "serve",
         "--a", os.path.join(assets, "npr_A.png"),
         "--ap", os.path.join(assets, "npr_Ap.png"), "--device", "cpu",
         "--levels", "2", "--em-iters", "1", "--pm-iters", "2",
         "--port", "0", "--max-wait-ms", "5", "--warmup", str(warm),
         "--trace-dir", str(td), "--state-dir", str(sd)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    try:
        deadline = time.monotonic() + 120.0
        while not (td / "live.json").exists():
            assert proc.poll() is None, proc.communicate()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        url = json.loads((td / "live.json").read_text())["url"]
        code, resp = _serve_post(url, frame, "cli-req-1")
        assert code == 200 and resp["cache"] == "hit"
        assert resp["shape"] == [48, 48, 3]
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "drained, exiting" in out
    flight = json.loads((td / "flight.json").read_text())
    assert flight["flushed_on"] == "drain"
    assert json.loads((sd / "warmup.observed.json").read_text())[
        "entries"] == [{"height": 48, "width": 48, "channels": 3}]
    res = subprocess.run(
        [sys.executable, "-m", "image_analogies_tpu_torch.cli", "trace",
         "cli-req-1", "--trace-dir", str(td), "--format", "json"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout)["access"]
    phases = sum(rec[k] for k in ("queue_ms", "compile_ms", "execute_ms",
                                  "demux_ms"))
    assert phases == pytest.approx(rec["total_ms"], rel=0.05)


def test_module_entry_point_runs_without_cuda(assets, tmp_path):
    """`python -m image_analogies_tpu_torch.cli` in a fresh process, on
    the CPU: it writes its output and never initialises CUDA."""
    out = str(tmp_path / "bp.png")
    code = (
        "import sys, torch; from image_analogies_tpu_torch import cli; "
        "torch.set_num_threads(1); rc = cli.main(sys.argv[1:]); "
        "assert not torch.cuda.is_initialized(); sys.exit(rc)"
    )
    res = subprocess.run(
        [sys.executable, "-c", code] + _synth(assets) + [
            "--out", out, "--levels", "1", "--em-iters", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert res.returncode == 0, res.stderr
    assert os.path.exists(out)
    res = subprocess.run(
        [sys.executable, "-m", "image_analogies_tpu_torch.cli", "synth",
         "--a", "x", "--ap", "x", "--b", "x", "--out", out, "--spatial"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0 and "step 14" in res.stderr
