"""The port's shape-only stand-ins (``Model.init_shapes``,
``Model.input_specs``) against the reference's ``jax.eval_shape`` trees.

Both packages' trees are flattened to {path: (shape, dtype)}, a path being
the dict keys, list indices and dataclass field names from the root; the
two maps must be equal.  ``init_shapes`` is checked for all ten configs at
full size (meta tensors: nothing allocated), and against the port's own
``init`` at ``reduced_config`` size; ``input_specs`` for every config and
every shape cell it runs (``cells_for``), decode caches included, and with
``per_device_batch``.
"""
import jax
import pytest

from repro import configs as RC
from repro.models import build_model as ref_build

import repro_torch.configs as PC
from repro_torch.models import build_model
from repro_torch.parallel.sharding import tree_map_with_path

ARCHS = sorted(RC.ARCHS)
CELLS = [(a, s) for a in ARCHS for s in RC.cells_for(RC.get_config(a))]


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(f"unknown key {k!r}")


def _ref_map(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(_key(k) for k in path): (tuple(x.shape), str(x.dtype)) for path, x in flat}


def _port_map(tree, device: str = "meta") -> dict:
    out = {}

    def add(path, t):
        assert t.device.type == device, path
        out[tuple(path)] = (tuple(t.shape), str(t.dtype).removeprefix("torch."))
        return t

    tree_map_with_path(add, tree)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_equal_the_reference_at_full_size(arch):
    got = build_model(PC.get_config(arch)).init_shapes()
    want = _ref_map(ref_build(RC.get_config(arch)).init_shapes())
    assert _port_map(got) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_equal_init_at_reduced_size(arch):
    m = build_model(PC.reduced_config(PC.get_config(arch)))
    assert _port_map(m.init_shapes(3)) == _port_map(m.init(3, device="cpu"), "cpu")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    got = build_model(PC.get_config(arch)).input_specs(PC.SHAPES[shape])
    want = ref_build(RC.get_config(arch)).input_specs(RC.SHAPES[shape])
    assert _port_map(got) == _ref_map(want)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "llama-3.2-vision-11b", "qwen3-0.6b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_per_device_batch(arch, shape):
    got = build_model(PC.get_config(arch)).input_specs(PC.SHAPES[shape], per_device_batch=3)
    want = ref_build(RC.get_config(arch)).input_specs(RC.SHAPES[shape], per_device_batch=3)
    assert _port_map(got) == _ref_map(want)
