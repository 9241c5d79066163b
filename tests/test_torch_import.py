"""The port stands alone: it imports with JAX blocked, never pulls in the
JAX package, and no source line of it imports either."""

import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "real_time_audio_sync_tpu_torch"

_BLOCKED_IMPORT = """
import pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import real_time_audio_sync_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    __import__(m.name)
import chip_smoke
assert "real_time_audio_sync_tpu" not in sys.modules, "the JAX package was imported"
assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules if sys.modules[k] is not None)
print("ok")
"""


def test_port_imports_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No CUDA device here: chip_smoke.py must exit non-zero and print no
    result, both from the repository and copied into an empty directory."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


@pytest.mark.parametrize("module", ["parallel.wtw_serving", "models.wtw_async"])
def test_module_imports_alone_with_jax_blocked(module):
    """A module imported on its own, with JAX blocked, pulls in neither
    JAX nor the JAX package."""
    code = (f"import sys; sys.modules['jax'] = None; import real_time_audio_sync_tpu_torch.{module}; "
            "assert 'real_time_audio_sync_tpu' not in sys.modules; "
            "assert not any(k.startswith('jax') for k, v in sys.modules.items() if v is not None); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_source_line_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax\b|real_time_audio_sync_tpu\b(?!_torch))", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in files if pattern.search(p.read_text())]
    assert not offenders, offenders


ENTRY_POINTS = [
    ("streaming.runtime", "ScoreFollower"),
    ("models.fused_streaming", "FusedStreamingEngine"),
    ("parallel.serving", "FusedMultiStreamFollower"),
    ("parallel.wtw_serving", "FusedMultiStreamWTW"),
    ("models.wtw", "WTW"),
    ("models.fused_wtw", "FusedWTW"),
    ("streaming.runtime", "WTWFollower"),
    ("eval.wtw_offline", "WTWOfflineEvaluator"),
    ("parallel.transfer", "probe_link_bandwidth"),
    ("parallel.transfer", "resolve_transfer_mode"),
    ("features.chroma", "frontend_constants"),
    ("features.chroma", "chroma_from_samples"),
    ("features.chroma", "wav_to_chroma"),
    ("features.chroma", "wav_to_chroma_col"),
    ("features.chroma", "wav_to_chroma_diff"),
    ("features.chroma", "chroma_diff_from_samples"),
    ("ops.otw_set_live", "pallas_set_live"),
    ("ops.otw_set_live", "pallas_batched_set_live"),
    ("models.dtw", "DTW"),
    ("models.dtw", "dtw_device"),
    ("models.dtw", "dtw_auto"),
    ("ops.banded_dtw", "dtw_banded"),
    ("eval.corpus", "align_pair"),
    ("eval.corpus", "CorpusRunner"),
    ("eval.corpus", "run_simple"),
    ("models.otw", "OnlineTimeWarping"),
    ("models.livenote", "LiveNote"),
    ("models.livenote_v2", "LiveNoteV2"),
    ("parallel.serving", "MultiStreamFollower"),
    ("models.wtw_async", "AsyncWTW"),
    ("parallel.wtw_serving", "MultiStreamWTW"),
]


@pytest.mark.parametrize("module,name", ENTRY_POINTS, ids=[name for _, name in ENTRY_POINTS])
def test_entry_points_default_to_the_card(module, name):
    """Every public entry point runs on the card unless the caller asks
    for the CPU (read from the signature; nothing is run)."""
    import importlib
    import inspect

    entry = getattr(importlib.import_module(f"real_time_audio_sync_tpu_torch.{module}"), name)
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_cli_defaults_to_the_card(monkeypatch):
    """The CLI hands the corpus runner ``device="cuda"`` unless
    ``--device`` says otherwise (the runner is replaced; nothing is
    aligned)."""
    from real_time_audio_sync_tpu_torch.eval import corpus
    from real_time_audio_sync_tpu_torch.eval.__main__ import main

    seen = []

    class Recorder:
        def __init__(self, *args, device, **kwargs):
            seen.append(device)

        def evaluate(self, field_log=None):
            return None

    monkeypatch.setattr(corpus, "CorpusRunner", Recorder)
    assert main(["--corpus", "Songs", "--engine", "dtw"]) == 0
    assert main(["--corpus", "Songs", "--engine", "dtw", "--device", "cpu"]) == 0
    assert seen == ["cuda", "cpu"]


# public names that an object of one package has and the same object of the
# other lacks, each with the reason
NAME_DIFFERENCES = {
    "device": "port only: the torch device the state lives on and the kernels run on",
    "async_harvest": "JAX only: its status reads are relay round-trips on a helper thread; the port reads "
                     "pinned buffers behind CUDA events and has no helper thread to switch",
    "ref_t": "JAX only: the reference transposed onto 128 TPU lanes; the port keeps it in its engine "
             "state's own layout",
}


def _both(name):
    """The same object built by each package on the same inputs and
    arguments (``interpret=True``: JAX's kernels run in interpret mode on
    the CPU, and the port records the switch)."""
    import numpy as np

    from tests.test_pallas_wtw import WP, _synth

    feats = np.random.default_rng(0).random((12, 40)).astype(np.float32)
    band = {"c": 10, "max_run_count": 3}
    audio, _ = _synth(seed=1, ref_s=6)
    if name == "FusedStreamingEngine":
        from real_time_audio_sync_tpu.models.fused_streaming import FusedStreamingEngine as J
        from real_time_audio_sync_tpu_torch.models.fused_streaming import FusedStreamingEngine as T

        return J(feats, band, interpret=True), T(feats, band, interpret=True, device="cpu")
    if name == "FusedMultiStreamFollower":
        from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower as J
        from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamFollower as T

        return J(feats, band, 2, interpret=True), T(feats, band, 2, interpret=True, device="cpu")
    if name == "FusedWTW":
        from real_time_audio_sync_tpu.models.fused_wtw import FusedWTW as J
        from real_time_audio_sync_tpu_torch.models.fused_wtw import FusedWTW as T

        return J(audio, WP, interpret=True), T(audio, WP, interpret=True, device="cpu")
    if name in ("OnlineTimeWarping", "LiveNote", "LiveNoteV2"):
        from real_time_audio_sync_tpu import models as J
        from real_time_audio_sync_tpu_torch import models as T

        return getattr(J, name)(feats, band), getattr(T, name)(feats, band, device="cpu")
    if name == "MultiStreamFollower":
        from real_time_audio_sync_tpu.parallel.serving import MultiStreamFollower as J
        from real_time_audio_sync_tpu_torch.parallel import MultiStreamFollower as T

        return J([feats, feats[:, :30]], band), T([feats, feats[:, :30]], band, device="cpu")
    if name == "AsyncWTW":
        from real_time_audio_sync_tpu.models.wtw_async import AsyncWTW as J
        from real_time_audio_sync_tpu_torch.models import AsyncWTW as T

        return J(audio, WP), T(audio, WP, device="cpu")
    if name == "MultiStreamWTW":
        from real_time_audio_sync_tpu.parallel import MultiStreamWTW as J
        from real_time_audio_sync_tpu_torch.parallel import MultiStreamWTW as T

        return J([audio, audio], WP, transfer_dtype="float32"), T([audio, audio], WP, transfer_dtype="float32",
                                                                  device="cpu")
    if name == "FusedMultiStreamWTW":
        from real_time_audio_sync_tpu.parallel import FusedMultiStreamWTW as J
        from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamWTW as T

        kw = {"transfer_dtype": "float32", "interpret": True}
        return J([audio, audio], WP, **kw), T([audio, audio], WP, **kw, device="cpu")
    from real_time_audio_sync_tpu.models.wtw import WTW as J
    from real_time_audio_sync_tpu_torch.models.wtw import WTW as T

    return J(audio, WP), T(audio, WP, device="cpu")


@pytest.mark.parametrize("name", ["FusedStreamingEngine", "FusedMultiStreamFollower", "FusedWTW", "WTW",
                                  "FusedMultiStreamWTW", "OnlineTimeWarping", "LiveNote", "LiveNoteV2",
                                  "MultiStreamFollower", "AsyncWTW", "MultiStreamWTW"])
def test_public_names_match_the_jax_objects(name):
    """The public ``dir()`` names (which hold the public ``vars()``) of an
    object built in both packages differ only by ``NAME_DIFFERENCES``; the
    attributes the JAX package's own callers read have its meanings."""
    import numpy as np

    jax_obj, port_obj = _both(name)

    def public(o):
        return {n for n in dir(o) if not n.startswith("_")}

    differ = public(jax_obj) ^ public(port_obj)
    assert differ <= set(NAME_DIFFERENCES), sorted(differ - set(NAME_DIFFERENCES))
    shared = {"dtype", "interpret", "mesh", "caps", "n_max", "k_block", "b", "ref_lens", "N", "M", "f", "ms", "n_caps",
              "fft_len", "hop_size", "transfer_dtype"}
    for attr in sorted(shared & public(jax_obj)):
        got, want = getattr(port_obj, attr), getattr(jax_obj, attr)
        assert np.array_equal(np.asarray(got), np.asarray(want)), attr
