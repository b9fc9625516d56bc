"""Import hygiene of the PyTorch port: ``repro_torch`` and ``chip_smoke.py``
never import JAX or the reference package ``repro``."""
import os
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (parity suites import both packages)
import repro  # noqa: F401
import repro_torch  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_fresh_import_leaves_jax_and_repro_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core.shrink, repro_torch.kernels.ops, repro_torch.convert\n"
        "import repro_torch.core.tensorshrink, repro_torch.serving.kvcache\n"
        "import repro_torch.models.layers\n"
        "import repro_torch.core.streaming, repro_torch.analytics, repro_torch.serving.batching\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.models.transformer\n"
        "import repro_torch.models.model, repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.interval_stats, repro_torch.kernels.residual_quant\n"
        "import repro_torch.kernels.dequant\n"
        "import repro_torch.data, repro_torch.data.synthetic, repro_torch.testing\n"
        "import repro_torch.testing.chaos, repro_torch.parallel, repro_torch.parallel.fleet\n"
        "import repro_torch.serving.ragged, repro_torch.serving.kbstore\n"
        "import repro_torch.serving.gateway, repro_torch.serving.fleet\n"
        "import repro_torch.training, repro_torch.training.optimizer\n"
        "import repro_torch.training.train_step, repro_torch.training.grad_compress\n"
        "import repro_torch.training.checkpoint, repro_torch.training.fault_tolerance\n"
        "import repro_torch.training.metrics, repro_torch.data.pipeline\n"
        "import repro_torch.launch.train\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
    )
    assert out.stdout.strip() == "", f"port pulled in: {out.stdout.strip()}"


_BAD_IMPORT = re.compile(
    r"^\s*(import\s+(jax|repro)(\s|\.|,|$)|from\s+(jax|repro)(\s|\.))", re.MULTILINE
)


def test_no_source_names_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if _BAD_IMPORT.search(f.read_text())]
    assert offenders == []


def test_pattern_catches_what_it_must():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "import repro", "from repro.core import x", "  import repro.kernels"):
        assert _BAD_IMPORT.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x", "from . import jaxish"):
        assert not _BAD_IMPORT.search(line), line
