"""The port's training launcher (``python -m repro_torch.launch.train``) on
the CPU: a reduced qwen3-0.6b trains, exits 0 with the reference's printed
lines, and a second call resumes from its checkpoint directory; a resumed
run takes only the steps after the checkpoint.  ``--production`` (the
16 x 16 mesh) in a world of one raises ``ConfigError`` naming the 256
ranks it needs, for every config: an ``moe_ep`` config (deepseek) trains
its experts expert parallel, and a state larger than one card is no
reason either (each rank holds only its shards of it, so llama3-8b, 89 GiB
of params, gradients and moments whole, reaches the same error)."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.core.errors import ConfigError
from repro_torch.launch import train

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--batch", "2", "--seq", "32"]


def _losses(out: str) -> dict:
    return {int(m[1]): m[2] for m in re.finditer(r"^step +(\d+)  loss (\S+)  gnorm \S+$", out,
                                                   re.MULTILINE)}


def test_trains_exits_zero_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert train.main(ARGS + ["--steps", "12", "--ckpt-dir", ck, "--ckpt-every", "4"]) == 0
    first = capsys.readouterr().out
    assert first.splitlines()[0] == "arch=qwen3-0.6b params=0.1M mesh={'data': 1, 'model': 1}"
    assert re.search(r"^final loss \d+\.\d{4}$", first, re.MULTILINE)
    assert sorted(_losses(first)) == list(range(12))
    assert (tmp_path / "ck" / "LATEST").read_text() == "11"
    # resume: steps 12..15 only
    assert train.main(ARGS + ["--steps", "16", "--ckpt-dir", ck, "--ckpt-every", "4"]) == 0
    assert sorted(_losses(capsys.readouterr().out)) == [12, 13, 14, 15]
    assert (tmp_path / "ck" / "LATEST").read_text() == "15"


def test_module_entry_point_exits_zero(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS, "--steps", "3",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout


def test_production_raises_config_error():
    """In a world of one, ``--production`` raises naming the 256 ranks its
    16 x 16 mesh needs, before any process group exists."""
    with pytest.raises(ConfigError, match="needs a world of 256 ranks.*this world has 1"):
        train.main(ARGS + ["--production"])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch,reason", [
    ("deepseek-v2-lite-16b", "needs a world of 256 ranks.*this world has 1"),
    ("llama3-8b", "needs a world of 256 ranks.*this world has 1"),
])
def test_production_refuses_what_the_step_cannot_run(arch, reason):
    with pytest.raises(ConfigError, match=reason):
        train.main(["--arch", arch, "--production"])
    assert not torch.distributed.is_initialized()
