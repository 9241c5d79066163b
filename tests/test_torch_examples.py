"""The port's example scripts (``real_time_audio_sync_tpu_torch/examples/``:
``live_demo``, ``heatmap_overlay``, ``mic_smoke``) on the CPU, on the
synthetic "steady" pair that the tests render (``eval/synthetic``), against
followers of the port built directly and against the JAX package's scripts
and engines.

Tolerance: a script's field log equals the path of a follower built
directly on the same wavs, point for point; the click track equals the JAX
demo's byte for byte.  The port's device frontend and JAX's differ by up
to 2.15e-6 (docs/PARITY.md), which moves near-tie points, so the demo's
field log against JAX's demo compares ``PathScorer`` buckets within 1
point and their counts within 2.  On shared chroma the heatmap's
``set_live`` equals JAX's exactly (float32 accumulated cost and path) with
JAX's cost and min-plus arithmetic in place of the port's; with the port's
own (the kernels' sequential 12-term sum and doubling scan) the paths part
at an ulp-level near-tie, and the test compares ``PathScorer`` buckets."""

import contextlib
import io
import json
import os
import subprocess
import sys
from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from real_time_audio_sync_tpu_torch.eval import synthetic as tsyn  # noqa: E402
from real_time_audio_sync_tpu_torch.eval.logs import parse_field_log  # noqa: E402
from real_time_audio_sync_tpu_torch.eval.scorer import PathScorer  # noqa: E402
from real_time_audio_sync_tpu_torch.examples import heatmap_overlay, live_demo, mic_smoke  # noqa: E402
from real_time_audio_sync_tpu_torch.streaming import ScoreFollower, SimulatedMic, WTWFollower  # noqa: E402
from real_time_audio_sync_tpu_torch.utils.wavio import load_wav  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = (live_demo, heatmap_overlay, mic_smoke)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A short rendered pair (14.4 s reference, 12.9 s live) with beat CSVs."""
    root = tmp_path_factory.mktemp("songs")
    tsyn.build_corpus(str(root), ["steady"])
    return str(root / "steady" / "steady_00.wav"), str(root / "steady" / "steady_01.wav")


def _points(path):
    return [tuple(int(v) for v in p) for p in path]


def _direct(engine, ref, live, fused=False):
    """The follower the demo builds, fed the demo's 2048-sample buffers."""
    if engine in ("wtw", "wtw_async"):
        f = WTWFollower(ref, live, params=live_demo.WTW_PARAMS, engine=engine, device="cpu")
    else:
        f = ScoreFollower(ref, engine, {"c": 50, "max_run_count": 3}, pipelined=True, fused=fused, device="cpu")
    f.start()
    for buf in SimulatedMic(live, buffer_size=2048):
        f.receive_audio(buf)
        if f.stopped:
            break
    f.stop()
    return _points(f.path)


def _main(module, argv):
    """``module.main(argv)`` in process: (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = module.main(argv)
    return rc, out.getvalue(), err.getvalue()


@lru_cache(maxsize=None)
def _demo(ref, live, out_dir, *flags):
    """One in-process demo run with ``--out-dir``: (rc, stdout, the field
    log's path)."""
    rc, out, _ = _main(live_demo, ["--ref", ref, "--live", live, "--out-dir", out_dir, "--device", "cpu", *flags])
    (log,) = [n for n in os.listdir(out_dir) if n.endswith(".txt")]
    return rc, out, parse_field_log(os.path.join(out_dir, log)).path


@pytest.fixture(scope="module")
def demo_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("demo")


CASES = [("otw", ()), ("otw", ("--fused",)), ("livenote", ()), ("livenote_v2", ()), ("wtw", ()), ("wtw_async", ())]


@pytest.mark.parametrize("engine,flags", CASES, ids=["otw", "otw-fused", "livenote", "livenote_v2", "wtw",
                                                     "wtw_async"])
def test_live_demo_field_log_is_the_direct_followers_path(engine, flags, pair, demo_dir):
    """``live_demo.main([... "--device", "cpu"])`` for every engine choice:
    rc 0, the summary line, and a field log equal to the path of the
    follower the demo builds, made directly and fed the same buffers."""
    ref, live = pair
    out_dir = str(demo_dir / "-".join((engine,) + flags))
    rc, out, path = _demo(ref, live, out_dir, "--engine", engine, *flags)
    assert rc == 0 and "path points" in out
    assert len(path) > 100
    assert path == _direct(engine, ref, live, fused=bool(flags))
    assert os.path.getsize(os.path.join(out_dir, "click_track.wav")) > 10_000


def test_live_demo_against_the_jax_script(pair, demo_dir, tmp_path):
    """JAX's own ``examples/live_demo.py --engine otw`` (non-fused, on the
    CPU) and the port's: the same buffer count, the same click track byte
    for byte, field logs within 1 point a ``PathScorer`` bucket."""
    ref, live = pair
    proc = subprocess.run(
        [sys.executable, "examples/live_demo.py", "--ref", ref, "--live", live, "--engine", "otw", "--quiet",
         "--out-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "RTAS_NO_COMPILE_CACHE": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out_dir = str(demo_dir / "otw")
    _, out, path = _demo(ref, live, out_dir, "--engine", "otw")

    def followed(text):
        (line,) = [x for x in text.splitlines() if x.startswith("followed ")]
        return line.split(" -> ")[0]

    assert followed(out) == followed(proc.stdout)
    with open(tmp_path / "click_track.wav", "rb") as a, open(os.path.join(out_dir, "click_track.wav"), "rb") as b:
        assert a.read() == b.read()
    (jlog,) = tmp_path.glob("otw_test_live_*.txt")
    scorer = PathScorer.for_pair(ref, live)
    got, want = scorer.score(path), scorer.score(parse_field_log(str(jlog)).path)
    assert got.count == pytest.approx(want.count, abs=2)
    for t in got.pct_off_beats:
        assert abs(got.pct_off_beats[t] - want.pct_off_beats[t]) <= 1.0, t


def test_live_demo_tile_tiles_both_wavs(pair, tmp_path):
    """``--tile 2``: both recordings become ``np.tile`` of their samples, and
    the fused demo's field log on them is a direct follower's on the same
    tiled wavs (no beat CSV beside them, so no click track)."""
    ref, live = pair
    tiled = live_demo.tile_recordings(ref, live, 2, str(tmp_path))
    for src, dst in zip((ref, live), tiled):
        want, _ = load_wav(src)
        got, fs = load_wav(dst)
        assert fs == 22050
        np.testing.assert_array_equal(got, np.tile(want, 2))
    out_dir = tmp_path / "out"
    rc, out, _ = _main(live_demo, ["--ref", ref, "--live", live, "--tile", "2", "--fused", "--quiet",
                                   "--out-dir", str(out_dir), "--device", "cpu"])
    assert rc == 0 and "path points" in out
    (log,) = out_dir.glob("otw_test_live_*.txt")
    assert sorted(os.listdir(out_dir)) == [log.name]
    path = parse_field_log(str(log)).path
    assert len(path) > 300
    assert path == _direct("otw", *tiled, fused=True)


@pytest.fixture(scope="module")
def jax_chroma(pair):
    import real_time_audio_sync_tpu as rtas

    return tuple(np.asarray(rtas.wav_to_chroma(p)) for p in pair)


def _jax_arithmetic(monkeypatch):
    """Put JAX's cost (``1 - q @ bank``, the root of a summed square) and
    min-plus chain (``lax.associative_scan``) in place of the port's, one
    stream at a time, through JAX's own functions."""
    import jax
    import jax.numpy as jnp

    from real_time_audio_sync_tpu.ops import band as jband
    from real_time_audio_sync_tpu_torch.models import online_core
    from real_time_audio_sync_tpu_torch.ops import band

    @jax.jit
    def dot_cost(q, bank):
        return 1.0 - q @ bank

    @jax.jit
    def cell_cost(q, b):
        return 1.0 - q @ b

    @jax.jit
    def sq_cost(q, bank):
        d = bank - q[:, None]
        return jnp.sqrt(jnp.sum(d * d, axis=0))

    chain = jax.jit(jband._minplus_chain, static_argnames="exact")

    def cost(query, bank, euclidean):
        rows = []
        for q, b in zip(query.numpy(), bank.numpy()):
            if euclidean:
                rows.append(np.asarray(sq_cost(q, b)))
            elif b.shape[1] == 1:  # eval_cell's one cell: JAX's vector dot
                rows.append(np.asarray(cell_cost(q, b[:, 0]))[None])
            else:
                rows.append(np.asarray(dot_cost(q, b)))
        return torch.from_numpy(np.stack(rows))

    def minplus(b_win, c_win, r_init, exact):
        return torch.from_numpy(np.stack([np.asarray(chain(b, c, r, exact)) for b, c, r in
                                          zip(b_win.numpy(), c_win.numpy(), r_init.numpy())]))

    monkeypatch.setattr(band, "_cost_vector", cost)
    monkeypatch.setattr(online_core, "_cost_vector", cost)
    monkeypatch.setattr(band, "_minplus_chain", minplus)


def test_heatmap_costs_equal_jax_set_live_on_shared_chroma(pair, jax_chroma, monkeypatch):
    """``overlay_costs`` on JAX's ``wav_to_chroma`` columns against JAX's
    ``LiveNote``/``LiveNoteV2.set_live`` (what JAX's heatmap_overlay draws),
    float32: with JAX's cost and chain arithmetic in place of the port's,
    the accumulated cost (to the live pointer) and the path are equal
    exactly; with the port's own, the paths score within 1 point a
    ``PathScorer`` bucket (the ulp-level part of ROADMAP Queue 3 item 12)."""
    from real_time_audio_sync_tpu.models import LiveNote as JLiveNote
    from real_time_audio_sync_tpu.models import LiveNoteV2 as JLiveNoteV2

    ref_seq, live_seq = jax_chroma
    assert ref_seq.dtype == np.float32
    want = {}
    for name, cls in (("LiveNote", JLiveNote), ("LiveNoteV2", JLiveNoteV2)):
        eng = cls(ref_seq, heatmap_overlay.PARAMS)
        eng.set_live(live_seq)
        want[name] = (np.asarray(eng.acc_cost)[: eng.live_ptr + 1], np.asarray(eng.path_array))
    own = heatmap_overlay.overlay_costs(ref_seq, live_seq, device="cpu")
    with monkeypatch.context() as mp:
        _jax_arithmetic(mp)
        shared = heatmap_overlay.overlay_costs(ref_seq, live_seq, device="cpu")
    scorer = PathScorer.for_pair(*pair)
    for name, (acc, path) in want.items():
        assert shared[name][0].dtype == np.float32
        np.testing.assert_array_equal(shared[name][0], acc, err_msg=name)
        np.testing.assert_array_equal(shared[name][1], path, err_msg=name)
        got, ref_score = scorer.score(_points(own[name][1])), scorer.score(_points(path))
        assert got.count == pytest.approx(ref_score.count, abs=2)
        for t in got.pct_off_beats:
            assert abs(got.pct_off_beats[t] - ref_score.pct_off_beats[t]) <= 1.0, (name, t)


def test_heatmap_main_writes_the_overlay(pair, demo_dir, tmp_path):
    """``heatmap_overlay.main`` with a demo's field log overlaid writes a
    PNG of over 10 KB, and nothing else."""
    ref, live = pair
    _, _, _ = _demo(ref, live, str(demo_dir / "otw"), "--engine", "otw")
    (log,) = (demo_dir / "otw").glob("otw_test_live_*.txt")
    out = tmp_path / "overlay.png"
    rc, text, _ = _main(heatmap_overlay, ["--ref", ref, "--live", live, "--field-log", str(log), "--out", str(out),
                                          "--device", "cpu"])
    assert rc == 0 and f"wrote {out}" in text
    assert out.stat().st_size > 10_000
    assert os.listdir(tmp_path) == ["overlay.png"]


def _no_backend(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyaudio", None)  # a None entry makes the import raise ImportError
    monkeypatch.setitem(sys.modules, "sounddevice", None)


def test_mic_smoke_without_a_backend_skips(pair, monkeypatch):
    _no_backend(monkeypatch)
    rc, out, err = _main(mic_smoke, ["--ref", pair[0], "--device", "cpu"])
    assert rc == 2 and err.startswith("SKIP: no microphone backend available") and out == ""


class _FakeMic:
    """``MicSource``'s shape: fixed buffers from a recording."""

    samples = None

    def __init__(self, buffer_size=512, sample_rate=22050):
        self.buffer_size = buffer_size

    def __iter__(self):
        for pos in range(0, len(self.samples), self.buffer_size):
            yield self.samples[pos : pos + self.buffer_size]


def test_mic_smoke_follows_the_microphone(pair, monkeypatch):
    """With ``MicSource`` yielding the live wav's 512-sample buffers: exit 0
    and the path of a pipelined OTW follower fed the same buffers."""
    from real_time_audio_sync_tpu_torch import streaming
    from real_time_audio_sync_tpu_torch.streaming import sources

    ref, live = pair
    samples, _ = load_wav(live)
    monkeypatch.setattr(_FakeMic, "samples", samples)
    monkeypatch.setattr(sources, "MicSource", _FakeMic)
    made = []

    class Recorded(ScoreFollower):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    monkeypatch.setattr(streaming, "ScoreFollower", Recorded)
    rc, out, err = _main(mic_smoke, ["--ref", ref, "--device", "cpu"])
    assert rc == 0 and err == ""
    (follower,) = made
    assert follower.engine_name == "otw" and follower.pipelined and not follower.fused
    direct = ScoreFollower(ref, "otw", pipelined=True, device="cpu")
    direct.start()
    for buf in SimulatedMic(samples=samples, buffer_size=512):
        direct.receive_audio(buf)
        if direct.stopped:
            break
    direct.stop()
    assert len(direct.path) > 100 and _points(follower.path) == _points(direct.path)
    assert f"{len(direct.path)} path points" in out.splitlines()[-1]


def test_mic_smoke_silence_warns(pair, monkeypatch):
    """Silent buffers: exit 1 and the noise-floor warning."""
    from real_time_audio_sync_tpu_torch.streaming import sources

    monkeypatch.setattr(_FakeMic, "samples", np.zeros(512 * 40, np.float32))
    monkeypatch.setattr(sources, "MicSource", _FakeMic)
    rc, out, err = _main(mic_smoke, ["--ref", pair[0], "--device", "cpu"])
    assert rc == 1 and "WARNING: input level never rose above the noise floor" in err
    assert "peak level -96.0 dB" in out


_CHILD = """
import json, runpy, sys
sys.modules["pyaudio"] = sys.modules["sounddevice"] = None  # no microphone backend
ref, live, out = sys.argv[1:4]
sys.argv = ["live_demo", "--ref", ref, "--live", live, "--fused", "--quiet", "--device", "cpu"]
try:
    runpy.run_module("real_time_audio_sync_tpu_torch.examples.live_demo", run_name="__main__", alter_sys=True)
    rc = None
except SystemExit as e:
    rc = e.code
from real_time_audio_sync_tpu_torch.examples import heatmap_overlay, mic_smoke
rcs = [rc, heatmap_overlay.main(["--ref", ref, "--live", live, "--out", out, "--device", "cpu"]),
       mic_smoke.main(["--ref", ref, "--device", "cpu"])]
print(json.dumps({"rcs": rcs, "modules": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                                                 or m.split(".")[0] == "real_time_audio_sync_tpu")}))
"""


def test_scripts_import_no_jax(pair, tmp_path):
    """In a fresh interpreter, ``-m real_time_audio_sync_tpu_torch.examples.live_demo
    --device cpu`` exits 0, and after it and the other two scripts' mains no
    module of JAX or of the JAX package is loaded."""
    ref, live = pair
    proc = subprocess.run([sys.executable, "-c", _CHILD, ref, live, str(tmp_path / "o.png")], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result == {"rcs": [0, 0, 2], "modules": []}
    assert "path points" in proc.stdout


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_scripts_default_to_cuda_and_fail_loudly_without_it(script, pair, monkeypatch, tmp_path):
    """Without ``--device cpu``, on a machine with no CUDA device, each
    script ends non-zero with a message naming CUDA, before it builds
    anything (mic_smoke before it looks for a microphone)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref, live = pair
    argv = {"live_demo": ["--ref", ref, "--live", live, "--out-dir", str(tmp_path)],
            "heatmap_overlay": ["--ref", ref, "--live", live, "--out", str(tmp_path / "o.png")],
            "mic_smoke": ["--ref", ref]}[script.__name__.rsplit(".", 1)[1]]
    with pytest.raises(SystemExit) as e:
        script.main(argv)
    assert isinstance(e.value.code, str) and "CUDA" in e.value.code and "--device cpu" in e.value.code
    assert os.listdir(tmp_path) == []
