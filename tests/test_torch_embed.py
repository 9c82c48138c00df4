"""The embed pipeline (pipelines/embed.py) and the synthetic tree
(data/synthetic.py) of the port against the JAX package, on the CPU.

One tiny tree (20 train rows, some images missing), preprocessed once; the
same tokenizer file; the JAX package's tiny encoders (TINY_TEST, VIT_TEST,
fp32) carried into the port through bridge.py; batch 8, so the last batch
is a padded tail. Tolerances:
  * ids, labels, counts, skipped rows and the resume cursor: exact;
  * the four float16 embedding columns: within one float16 step at each
    value (rtol 2^-9) plus 1e-4: both compute in fp32 (sums in another
    order) and round once to float16;
  * the on-device bf16 -> float16 cast against the JAX package's host cast
    of the same bf16 values: bit for bit.
"""

import dataclasses
import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mmd_tpu.data.store import ArrayStore as JStore
from mmd_tpu.data.synthetic import synthetic_factify_tree as j_tree
from mmd_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from mmd_tpu.models import frozen as JF
from mmd_tpu.models import text_encoder as jte
from mmd_tpu.models import vit as jvit
from mmd_tpu.pipelines import embed as JE
from mmd_tpu.pipelines.preprocess import preprocess_csv
from mmd_tpu_torch import bridge
from mmd_tpu_torch.data.store import ArrayStore
from mmd_tpu_torch.data.synthetic import synthetic_factify_tree
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmd_tpu_torch.models import frozen as TF
from mmd_tpu_torch.models import text_encoder as te
from mmd_tpu_torch.models import vit as tvit
from mmd_tpu_torch.pipelines import embed as TE

torch.set_num_threads(2)

B, MAX_LEN, N_TRAIN = 8, 24, 20
EMB_RTOL, EMB_ATOL = 2.0 ** -9, 1e-4
EMBEDS = ["claim_text_embeds", "doc_text_embeds", "claim_image_embeds",
          "doc_image_embeds"]


@pytest.mark.parametrize("learnable", [False, True])
def test_synthetic_tree_is_the_jax_tree_byte_for_byte(tmp_path, learnable):
    kw = dict(n_train=6, n_test=3, image_size=24, seed=4,
              learnable=learnable)
    j_tree(tmp_path / "jax", **kw)
    synthetic_factify_tree(tmp_path / "port", **kw)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*")
                           if p.is_file())
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (
            tmp_path / "jax" / f).read_bytes(), f
    text = (tmp_path / "port" / "data/raw/factify/extracted/train.csv"
            ).read_text()
    assert ("entitytrain1" in text) is learnable


def test_device_cast_is_the_host_cast():
    """bf16 -> float16 on the device (the port) against numpy's cast of the
    same bf16 array on the host (the JAX package): normals, float16
    subnormals and underflow, overflow to inf, ties, signed zeros, inf."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(200_000) * 2.0 ** rng.integers(
        -30, 20, 200_000)).astype(np.float32)
    x = np.concatenate([x, np.float32([0.0, -0.0, np.inf, -np.inf, 65504,
                                       65519, 65520, 65536, 2.0 ** -24,
                                       2.0 ** -25, 3 * 2.0 ** -26])])
    host = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float16)
    dev = torch.from_numpy(x).to(torch.bfloat16).to(torch.float16).numpy()
    np.testing.assert_array_equal(dev.view(np.uint16), host.view(np.uint16))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A preprocessed tree, the tokenizer file and the tiny encoders of
    both packages with the same params; MMD_TPU_ROOT points at the tree
    while the module runs."""
    root = tmp_path_factory.mktemp("embed")
    synthetic_factify_tree(root, n_train=N_TRAIN, n_test=4, image_size=40,
                           seed=2)
    csv = preprocess_csv("train", root)
    df = pd.read_csv(csv)
    texts = df[["claim", "evidence"]].stack().astype(str).tolist()
    JTokenizer.train(texts, 200).save(root / "tok.json")
    jtok = JTokenizer.load(root / "tok.json")
    ttok = WordPieceTokenizer.load(root / "tok.json")
    jtc = dataclasses.replace(jte.TINY_TEST,
                              vocab_size=max(jtok.vocab_size, 128))
    tp = jte.init_text_encoder(jax.random.key(1), jtc)
    vp = jvit.init_vit(jax.random.key(2), jvit.VIT_TEST)
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    ttc = te.TransformerConfig(**dataclasses.asdict(jtc))
    jenc = JF.FrozenEncoders(jtok, jtc, tp, jvit.VIT_TEST, vp)

    def port_enc():
        return TF.FrozenEncoders(
            ttok, ttc, bridge.text_encoder_from_jax(np_tree(tp), ttc),
            tvit.VIT_TEST, bridge.vit_from_jax(np_tree(vp), tvit.VIT_TEST))

    old = os.environ.get("MMD_TPU_ROOT")
    os.environ["MMD_TPU_ROOT"] = str(root)
    kw = dict(batch_size=B, max_length=MAX_LEN, io_workers=2)
    jstore = JE.embed_csv(str(csv), jenc, store_path=str(root / "jax.store"),
                          **kw)
    tstore = TE.embed_csv(str(csv), port_enc(),
                          store_path=str(root / "port.store"), device="cpu",
                          **kw)
    yield dict(root=root, csv=str(csv), df=df, jstore=jstore, tstore=tstore,
               port_enc=port_enc, kw=kw)
    if old is None:
        os.environ.pop("MMD_TPU_ROOT")
    else:
        os.environ["MMD_TPU_ROOT"] = old


def _both_images(root, df) -> np.ndarray:
    ok = []
    for c, e in zip(df["claim_image"], df["evidence_image"]):
        ok.append(isinstance(c, str) and isinstance(e, str)
                  and (root / c).exists() and (root / e).exists())
    return np.asarray(ok)


def _meta(store) -> dict:
    return json.loads((store.dir / "meta.json").read_text())


def _assert_rows(got, want, exact_from: int = None):
    assert len(got) == len(want)
    for c in ("id", "labels"):
        np.testing.assert_array_equal(got.col(c), want.col(c), err_msg=c)
    for c in EMBEDS:
        g, w = got.col(c), want.col(c)
        assert g.dtype == np.float16 and g.shape == w.shape, c
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                                   rtol=EMB_RTOL, atol=EMB_ATOL, err_msg=c)
        if exact_from is not None:
            np.testing.assert_array_equal(g[exact_from:], w[exact_from:],
                                          err_msg=c)


def test_embed_matches_jax(tree):
    js, ts = tree["jstore"], tree["tstore"]
    valid = _both_images(tree["root"], tree["df"])
    assert 0 < valid.sum() < N_TRAIN             # some rows were skipped
    assert len(ts) == len(js) == valid.sum()
    np.testing.assert_array_equal(ts.col("id"),
                                  tree["df"]["id"].to_numpy()[valid])
    assert ts.column_specs == js.column_specs
    _assert_rows(ts, js)
    assert _meta(ts)["extra"] == _meta(js)["extra"] == {
        "csv_cursor": N_TRAIN}
    assert (tree["root"] / "port.store" / "meta.json").read_text() == (
        tree["root"] / "jax.store" / "meta.json").read_text()


def test_a_finished_store_takes_no_rows(tree):
    before = {c: tree["tstore"].col(c).copy() for c in ("id", *EMBEDS)}
    again = TE.embed_csv(tree["csv"], tree["port_enc"](),
                         store_path=str(tree["tstore"].dir), device="cpu",
                         **tree["kw"])
    assert len(again) == len(tree["tstore"])
    for c, v in before.items():
        np.testing.assert_array_equal(again.col(c), v)


@pytest.mark.parametrize("cursor", ["extra", "cursor_txt"])
def test_resume_of_a_jax_store_equals_the_ports_own(tree, tmp_path, cursor):
    """The JAX package's store rewound to its first batch (count and
    cursor, in meta.json or as a legacy cursor.txt), resumed by the port:
    the port's own store, the first batch within tolerance (the JAX
    package encoded it), every later row bit for bit."""
    d = tmp_path / "resumed.store"
    shutil.copytree(tree["jstore"].dir, d)
    first = int((tree["jstore"].col("id") <= tree["df"]["id"][B - 1]).sum())
    meta = json.loads((d / "meta.json").read_text())
    meta["count"] = first
    if cursor == "extra":
        meta["extra"] = {"csv_cursor": B}
    else:
        meta.pop("extra")
        (d / "cursor.txt").write_text(str(B))
    (d / "meta.json").write_text(json.dumps(meta))
    resumed = TE.embed_csv(tree["csv"], tree["port_enc"](), store_path=str(d),
                           device="cpu", **tree["kw"])
    _assert_rows(resumed, tree["tstore"], exact_from=first)
    assert _meta(resumed)["extra"]["csv_cursor"] == N_TRAIN
    assert len(JStore(d)) == len(tree["tstore"])


def test_main_runs_on_the_cpu_and_refuses_a_missing_card(tree, tmp_path):
    argv = ["--csv", tree["csv"], "--tiny", "--assets", str(tmp_path),
            "--batch_size", "16", "--store", str(tmp_path / "s")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TE.main(argv)
        assert not (tmp_path / "s").exists()
    store = TE.main(argv + ["--device", "cpu"])
    assert len(store) == len(tree["tstore"])
    assert store.col("claim_text_embeds").shape[1:] == (
        512, te.TINY_TEST.hidden_size)
    assert (tmp_path / "tokenizer.json").exists()
    assert TE.store_path_for_csv(tree["csv"]) == JE.store_path_for_csv(
        tree["csv"])
