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


def test_no_source_line_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax\b|real_time_audio_sync_tpu\b(?!_torch))", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in files if pattern.search(p.read_text())]
    assert not offenders, offenders


ENTRY_POINTS = [
    ("streaming.runtime", "ScoreFollower"),
    ("models.fused_streaming", "FusedStreamingEngine"),
    ("parallel.serving", "FusedMultiStreamFollower"),
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
