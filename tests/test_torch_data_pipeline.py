"""The port's data pipeline and metrics logger against the reference's, on
the CPU: ``TokenPipeline`` batches equal array for array, ``ShardStore``
and ``MetricsLogger`` write byte-identical files (with ``zstd``, and with
``rans`` where ``zstandard`` does not import, as on the card's machine)
and read back the reference's values."""
import json

import numpy as np
import pytest

from repro.core import entropy as RE
from repro.data import pipeline as RP
from repro.training.metrics import MetricsLogger as RefLogger

from repro_torch.core import entropy as PE
from repro_torch.data import pipeline as PP
from repro_torch.training.metrics import MetricsLogger


@pytest.mark.parametrize("batch,n_shards", [(4, 16), (32, 16), (6, 4), (5, 2)])
def test_token_pipeline_batches_equal(batch, n_shards):
    kw = dict(vocab_size=1000, batch=batch, seq_len=48, seed=7, n_shards=n_shards)
    rp, pp = RP.TokenPipeline(**kw), PP.TokenPipeline(**kw)
    for step in (0, 1, 17):
        want, got = rp.batch_at(step), pp.batch_at(step)
        assert set(got) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def _files(d):
    return {p.relative_to(d).as_posix(): p.read_bytes() for p in sorted(d.rglob("*"))
            if p.is_file()}


@pytest.fixture(params=["zstd", "rans"])
def backend(request, monkeypatch):
    """Both packages' store backend: zstd where it imports, else rans."""
    if request.param == "rans":
        for mod in (RE, PE):
            monkeypatch.setattr(mod, "available_backends",
                                lambda: ["rc", "rans", "raw", "bitpack"])
    assert RP._store_backend() == PP._store_backend() == request.param
    return request.param


def test_shard_store_files_byte_identical(backend, tmp_path):
    rng = np.random.default_rng(0)
    v = np.round(np.cumsum(rng.standard_normal(5000)) * 0.1, 3)
    eps = [0.05 * float(v.max() - v.min()), 0.0]
    rs = RP.ShardStore(tmp_path / "ref", chunk=2048)
    ps = PP.ShardStore(tmp_path / "port", chunk=2048, device="cpu")
    want, got = rs.put("s", v, eps, decimals=3), ps.put("s", v, eps, decimals=3)
    assert got == want
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    for e in eps:
        np.testing.assert_array_equal(ps.get("s", e), rs.get("s", e))
    np.testing.assert_array_equal(ps.get("s", 0.0), v)
    np.testing.assert_array_equal(ps.get_chunk("s", eps[0], 2), rs.get_chunk("s", eps[0], 2))
    assert ps.meta("s") == json.loads((tmp_path / "ref" / "s" / "meta.json").read_text())


def test_metrics_logger_files_byte_identical(backend, tmp_path):
    rng = np.random.default_rng(1)
    ref, port = RefLogger(tmp_path / "ref", chunk=64), MetricsLogger(tmp_path / "port", chunk=64,
                                                                     device="cpu")
    for flush in range(2):
        for step in range(100):
            m = {"loss": 3.0 - 0.01 * step + 0.05 * rng.standard_normal(),
                 "grad_norm": abs(rng.standard_normal())}
            ref.log(step, m)
            port.log(step, m)
        assert port.flush() == ref.flush()
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    for key in ("loss", "grad_norm"):
        for lossless in (True, False):
            np.testing.assert_array_equal(port.read(key, lossless), ref.read(key, lossless))
    assert port.read("missing").size == 0
