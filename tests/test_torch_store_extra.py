"""The store writer's `extra` (a producer's resume cursor, committed in the
same atomic meta.json write as the count) across the two packages: a store
the JAX writer started and the port's writer resumes keeps its cursor, and
the reverse. Before the port's writer kept `extra`, its next append
rewrote meta.json without it, so a resumed embed lost `csv_cursor` and
started again at row 0. Exact: the rows are copied, not computed."""

import json

import numpy as np
import pytest

from mmd_tpu.data.store import ArrayStore as JStore
from mmd_tpu.data.store import ArrayStoreWriter as JWriter
from mmd_tpu_torch.data.store import ArrayStore, ArrayStoreWriter

COLUMNS = {"id": ((), np.int64), "x": ((3,), np.float16)}


def _rows(lo, n):
    return {"id": np.arange(lo, lo + n, dtype=np.int64),
            "x": np.arange(3 * lo, 3 * (lo + n), dtype=np.float16
                           ).reshape(n, 3)}


@pytest.mark.parametrize("first,second", [(JWriter, ArrayStoreWriter),
                                          (ArrayStoreWriter, JWriter)],
                         ids=["jax_then_port", "port_then_jax"])
def test_extra_survives_the_other_writer(tmp_path, first, second):
    w = first(tmp_path / "s", capacity=8, columns=COLUMNS)
    w.append_batch(_rows(0, 3), extra={"csv_cursor": 8})
    w.finalize()

    w2 = second(tmp_path / "s", capacity=8, columns=COLUMNS)
    assert w2.count == 3 and w2.extra == {"csv_cursor": 8}
    w2.append_batch(_rows(3, 2))                 # no extra: the cursor stays
    assert json.loads((tmp_path / "s" / "meta.json").read_text())[
        "extra"] == {"csv_cursor": 8}
    w2.append_batch(_rows(5, 1), extra={"csv_cursor": 12})
    w2.update_extra(csv_cursor=16, note="done")
    w2.finalize()

    for reader in (ArrayStore, JStore):
        s = reader(tmp_path / "s")
        assert len(s) == 6
        np.testing.assert_array_equal(s.col("id"), np.arange(6))
    meta = json.loads((tmp_path / "s" / "meta.json").read_text())
    assert meta["extra"] == {"csv_cursor": 16, "note": "done"}
    assert first(tmp_path / "s", 8, COLUMNS).extra == meta["extra"]


def test_meta_json_equals_jax_writers(tmp_path):
    """Both writers write the same manifest for the same appends."""
    for name, writer in (("jax", JWriter), ("port", ArrayStoreWriter)):
        w = writer(tmp_path / name, capacity=5, columns=COLUMNS)
        w.append_batch(_rows(0, 2), extra={"csv_cursor": 3})
        w.update_extra(csv_cursor=5)
        w.finalize()
    assert (tmp_path / "port" / "meta.json").read_text() == (
        tmp_path / "jax" / "meta.json").read_text()
    for col in COLUMNS:
        assert (tmp_path / "port" / f"{col}.npy").read_bytes() == (
            tmp_path / "jax" / f"{col}.npy").read_bytes()


def test_reader_columns_and_rows(tmp_path):
    w = ArrayStoreWriter(tmp_path / "s", capacity=4, columns=COLUMNS)
    w.append_batch(_rows(0, 3))
    w.finalize()
    s, js = ArrayStore(tmp_path / "s"), JStore(tmp_path / "s")
    assert s.columns == js.columns == ["id", "x"]
    for i in (0, 2, slice(0, 2)):
        for k, v in s[i].items():
            np.testing.assert_array_equal(v, js[i][k])
