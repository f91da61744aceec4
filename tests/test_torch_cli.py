"""The port's command line on the CPU (`--device cpu`), as a user drives
it: the cases of tests/test_cli.py for `examples`, `synth` (progress
stream, checkpoints and a bit-identical resume; brute with kappa), the
`batch` flags and a bad matcher refused at parse time; and beside them:
the brute PNG against the JAX CLI's on the same assets (uint8 arrays
equal except at rounding boundaries), the PatchMatch PNG against the
port's library call bit for bit, `video` writing one frame per input
and naming each in its progress stream, the telemetry directory, a
supervised run healing a fault, and the step-12 flags (`--health`,
`--metrics-port`) running, the health epilogue on every runner; `serve
--device cpu` in its own process answering a request, draining on
SIGTERM and exiting 0, `trace --trace-dir` reconstructing that request
within 5 %, and `serve --n-devices 2 --device cpu` answering the
library's grain-2 dispatch over two ranks."""

import base64
import json
import os
import subprocess
import sys
import urllib.request

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


@pytest.mark.parametrize("flags", [
    ["--spatial"],
    ["--sharded-a"],
    ["--spatial", "--bands", "1"],
    ["--n-devices", "2"],
])
def test_step14_flags_now_run(assets, tmp_path, flags):
    """The multi-device flags (ROADMAP Queue 1 step 14) run: on one CPU
    rank each writes the single-device runner's PNG (`--n-devices`
    without a sharded runner leaves synth on one device)."""
    base = _synth(assets) + ["--levels", "2", "--em-iters", "1",
                             "--matcher", "brute"]
    assert _run(base + ["--out", str(tmp_path / "o.png")] + flags) == 0
    assert _run(base + ["--out", str(tmp_path / "ref.png")]) == 0
    np.testing.assert_array_equal(_png(tmp_path / "o.png"),
                                  _png(tmp_path / "ref.png"))


def test_bands_without_spatial_stops(assets, tmp_path):
    with pytest.raises(SystemExit) as exc:
        _run(_synth(assets) + ["--out", str(tmp_path / "o.png"),
                               "--bands", "2"])
    assert "--bands requires --spatial" in str(exc.value.code)
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


@pytest.mark.parametrize("warm", [None, "on"])
def test_video_over_ranks_needs_warm_off(assets, tmp_path, monkeypatch,
                                         warm):
    """`video --n-devices 2` with the warm path on (the default, or
    named) stops before any rank starts: the warm path runs its frames
    in turn, so every rank would run the whole sequence."""
    from image_analogies_tpu_torch.video import sequence

    monkeypatch.setattr(sequence, "_WARM_MODE", "on")
    frames, outdir = str(tmp_path / "frames"), str(tmp_path / "styled")
    os.makedirs(frames)
    Image.open(os.path.join(assets, "npr_frame_0.png")).save(
        os.path.join(frames, "t00.png"))
    argv = ["video", "--a", os.path.join(assets, "npr_A.png"),
            "--ap", os.path.join(assets, "npr_Ap.png"), "--frames", frames,
            "--out", outdir, "--device", "cpu", "--n-devices", "2"]
    with pytest.raises(SystemExit) as exc:
        _run(argv + (["--warm", warm] if warm else []))
    assert "needs --warm off" in str(exc.value.code)
    assert not os.path.exists(outdir)


def test_serve_over_two_cpu_ranks(assets, tmp_path):
    """`serve --n-devices 2 --device cpu`: rank 0 serves, a follower
    runs each dispatch with it; the answer is the library's grain-2
    dispatch bit for bit, /serving reports 2 devices, and SIGTERM drains
    both ranks to exit 0."""
    import signal
    import time

    from image_analogies_tpu_torch.parallel.batch import synthesize_batch
    from image_analogies_tpu_torch.serving.daemon import _luma_bucket

    td = tmp_path / "td"
    frame = to_uint8(load_image(os.path.join(assets, "npr_frame_0.png")))
    frame = np.ascontiguousarray(frame[:32, :32])
    proc = subprocess.Popen(
        [sys.executable, "-m", "image_analogies_tpu_torch.cli", "serve",
         "--a", os.path.join(assets, "npr_A.png"),
         "--ap", os.path.join(assets, "npr_Ap.png"), "--device", "cpu",
         "--n-devices", "2", "--levels", "2", "--em-iters", "1",
         "--pm-iters", "2", "--port", "0", "--max-wait-ms", "5",
         "--trace-dir", str(td)],
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
        code, resp = _serve_post(url, frame, "two-ranks-1")
        with urllib.request.urlopen(url + "/serving", timeout=30) as r:
            serving = json.loads(r.read())
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert code == 200 and resp["batch_size"] == 1
    assert serving["devices"] == 2 and serving["ranks"]["size"] == 2
    assert serving["policy"]["max_batch"] == 2
    f = frame.astype(np.float32) / 255.0
    want = synthesize_batch(
        load_image(os.path.join(assets, "npr_A.png")),
        load_image(os.path.join(assets, "npr_Ap.png")), np.stack([f, f]),
        SynthConfig(device="cpu", levels=2, em_iters=1, pm_iters=2),
        frame_indices=[0, 0], _b_stats=_luma_bucket(f))[0].numpy()
    got = np.frombuffer(base64.b64decode(resp["image_b64"]),
                        np.float32).reshape(resp["shape"])
    np.testing.assert_array_equal(got, want)


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
    --trace-dir` reconstructs the request within 5 %: its phases, from
    the connection's accept to the payload, sum to its wall."""
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
    from image_analogies_tpu_torch.serving.accesslog import phase_fields

    rec = json.loads(res.stdout)["access"]
    # Every phase of the request's clock, which runs from the
    # connection's accept to the payload (accept, ingest and encode
    # included), as `trace` itself sums them.
    phases = sum(ms for _, ms in phase_fields(rec))
    assert phases == pytest.approx(rec["total_ms"], rel=0.05)



def test_serve_drained_exits_0_under_late_sigterms(assets, tmp_path):
    """`serve` drained by `POST /drain` exits 0 on its own; a SIGTERM
    that reaches it while it exits (a supervisor stopping a process the
    router drained) finds nothing left to drain and leaves the exit code
    0, also once the interpreter has dropped its Python handlers."""
    import signal
    import time
    import urllib.request

    td = tmp_path / "td"
    proc = subprocess.Popen(
        [sys.executable, "-m", "image_analogies_tpu_torch.cli", "serve",
         "--a", os.path.join(assets, "npr_A.png"),
         "--ap", os.path.join(assets, "npr_Ap.png"), "--device", "cpu",
         "--levels", "1", "--em-iters", "1", "--pm-iters", "1",
         "--port", "0", "--trace-dir", str(td)],
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
        req = urllib.request.Request(url + "/drain", data=b"{}",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 202
        deadline = time.monotonic() + 120.0
        while proc.poll() is None and time.monotonic() < deadline:
            proc.send_signal(signal.SIGTERM)
            time.sleep(0.002)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "drained, exiting" in out

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
    # `serve --n-devices 2` on cuda (the default) without a card stops
    # at its device check, before any rank starts or CUDA initialises.
    code = (
        "import sys, torch\nfrom image_analogies_tpu_torch import cli\n"
        "try:\n    cli.main(sys.argv[1:])\n"
        "except SystemExit as e:\n    print(e.code)\n"
        "assert not torch.cuda.is_initialized()"
    )
    res = subprocess.run(
        [sys.executable, "-c", code, "serve", "--a", "x", "--ap", "x",
         "--n-devices", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert res.returncode == 0, res.stderr
    assert "no CUDA device" in res.stdout
