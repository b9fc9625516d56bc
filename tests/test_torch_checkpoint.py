"""The port's checkpoints (``repro_torch.training.checkpoint``) against the
reference's, on the CPU: the same state saved by both packages gives
byte-identical ``leaf_<i>.bin`` files for the ``none``, ``zstd`` and
``shrink:1e-3`` codecs, and manifests equal but for ``treedef`` (each
package describes its own tree); each package loads the other's
checkpoints to the same values (bit for bit; a ``shrink`` leaf decodes to
the same float64 values in both), bf16 leaves included, after
asynchronous saves and ``keep_n`` rotation.
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.training import checkpoint as RC

from repro_torch.training import checkpoint as PC
from repro_torch.training._tree import leaves, tree_map

CODECS = ["none", "zstd", "shrink:1e-3"]


def _state(seed=0):
    """numpy leaves: float32 walks (>= 1024 elements, so ``shrink`` codes
    them), a constant leaf and a short one (``shrink`` sends them to zstd),
    a bf16 leaf and the int32 step."""
    rng = np.random.default_rng(seed)
    walk = lambda *s: np.cumsum(rng.standard_normal(s).astype(np.float32) * 0.01,
                                axis=-1).astype(np.float32)
    return {
        "params": {"w": walk(4, 512), "ln": np.ones(64, np.float32), "b": [walk(1500), walk(7)]},
        "opt": {"m": walk(2048), "step": np.asarray(5, np.int32)},
        "h": walk(3, 600).astype(ml_dtypes.bfloat16),
    }


def _to_jax(state):
    return jax.tree.map(jnp.asarray, state)


def _to_torch(state):
    def one(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return tree_map(one, state)


def _values(x):
    """float64 values (bf16 exactly) of a jax array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64) if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, dtype=np.float64) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _manifest(d):
    m = json.loads((d / "manifest.json").read_text())
    m.pop("treedef")
    return m


@pytest.mark.parametrize("codec", CODECS)
def test_leaf_files_byte_identical_and_cross_loadable(codec, tmp_path):
    state = _state()
    RC.save_checkpoint(tmp_path / "ref", 3, _to_jax(state), codec=codec)
    PC.save_checkpoint(tmp_path / "port", 3, _to_torch(state), codec=codec)
    rd, pd = tmp_path / "ref" / "step_3", tmp_path / "port" / "step_3"
    assert _manifest(rd) == _manifest(pd)
    n = len(jax.tree.leaves(state))
    assert sorted(p.name for p in pd.iterdir()) == sorted(p.name for p in rd.iterdir())
    for i in range(n):
        assert (pd / f"leaf_{i}.bin").read_bytes() == (rd / f"leaf_{i}.bin").read_bytes(), i
    assert (tmp_path / "port" / "LATEST").read_text() == "3"
    if codec.startswith("shrink"):
        assert [m["codec"] for m in _manifest(pd)["leaves"]].count(codec) == 4

    # each package loads the other's
    got, step = PC.load_checkpoint(tmp_path / "ref", _to_torch(state))
    want, rstep = RC.load_checkpoint(tmp_path / "port", _to_jax(state))
    assert step == rstep == 3
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(_values(a), _values(b))
        assert a.dtype == getattr(torch, str(np.asarray(b).dtype)) or (
            a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16)
    if codec != "shrink:1e-3":  # lossless: the state itself
        for a, b in zip(leaves(got), leaves(state)):
            np.testing.assert_array_equal(_values(a), np.asarray(b, dtype=np.float64))


def test_shrink_without_zstandard_writes_raw_where_the_reference_needs_zstd(tmp_path,
                                                                            monkeypatch):
    """Where ``zstandard`` does not import, ``default_codec`` is ``none`` and
    a leaf that ``shrink`` cannot code is written raw (``rans`` codes the
    rest); the checkpoint loads to the same values."""
    monkeypatch.setattr(PC, "_zstd", None)
    assert PC.default_codec() == "none"
    state = _to_torch(_state())
    PC.save_checkpoint(tmp_path, 1, state, codec="shrink:1e-3")
    metas = _manifest(tmp_path / "step_1")["leaves"]
    assert "zstd" not in [m["codec"] for m in metas]
    got, _ = PC.load_checkpoint(tmp_path, state)
    for a, b, m in zip(leaves(got), leaves(state), metas):
        if m["codec"] == "none":
            assert torch.equal(a, b)
        else:
            # within eps, plus the float32 rounding of the decoded value
            b = _values(b).astype(np.float64)
            assert np.abs(_values(a) - b).max() <= m["eps"] + np.spacing(np.float32(np.abs(b).max()))


def test_async_saves_rotation_and_resume_across_packages(tmp_path):
    state = _state(1)
    pm = PC.CheckpointManager(tmp_path / "port", keep_n=2, codec="zstd")
    for s in (1, 2, 3, 4):  # LATEST is the last write to land: one save in flight at a time
        pm.save(s, _to_torch(_state(s)), asynchronous=True)
        pm.wait()
    assert sorted(p.name for p in (tmp_path / "port").glob("step_*")) == ["step_3", "step_4"]
    assert PC.latest_step(tmp_path / "port") == 4
    want, step = RC.CheckpointManager(tmp_path / "port").restore(_to_jax(state))
    assert step == 4
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(_state(4))):
        np.testing.assert_array_equal(_values(a), np.asarray(b, dtype=np.float64))
    rm = RC.CheckpointManager(tmp_path / "ref", keep_n=2, codec="zstd")
    for s in (5, 6, 7):
        rm.save(s, _to_jax(_state(s)), asynchronous=True)
        rm.wait()
    got, step = PC.CheckpointManager(tmp_path / "ref").restore(_to_torch(state))
    assert step == 7
    for a, b in zip(leaves(got), leaves(_state(7))):
        np.testing.assert_array_equal(_values(a), np.asarray(b, dtype=np.float64))


def test_shardings_place_leaves(tmp_path):
    state = _to_torch(_state())
    PC.save_checkpoint(tmp_path, 0, state, codec="none")
    places = tree_map(lambda _: torch.device("cpu"), state)
    got, _ = PC.load_checkpoint(tmp_path, state, shardings=places)
    assert all(a.device.type == "cpu" for a in leaves(got))
    with pytest.raises(FileNotFoundError):
        PC.load_checkpoint(tmp_path / "empty", state)
