"""python -m mmd_tpu_torch.pipelines.run_all over the ranks of a launch, on
the CPU at tiny widths, against the single-device run (which
tests/test_torch_run_all.py and the stages' own files hold against the JAX
package; the JAX run_all cannot run on the CPU, `require_tpu`):

  * (a) a world of one (a gloo process group of one in this process) is
    the single-device run bit for bit at dropout 0.1: every trained
    fusion param, every logged loss and eval.csv;
  * (b) a spawned world of 2 gloo ranks in fp32 at dropout 0 against the
    single-device run in fp32 at dropout 0: the losses rank 0 logged
    (rtol 1e-6, atol 1e-6) and both ranks' gathered params (rtol 1e-4,
    atol steps * lr; tests/test_torch_tp_training.py's limits), the two
    ranks' params equal; rank 1 opened no file of the tree for writing, rank 0 wrote
    every file the single-device run wrote and no other, and each file
    is the single-device run's (byte for byte, but for the training's
    results, held at the limits above, and the timings);
  * (c) in the same world `--fused` raises ValueError on both ranks before
    anything is written;
  * the train CLI's launch helpers moved to parallel/launch.py:
    `on_rank0` re-raises rank 0's failure on every rank.

Dropout 0 in (b) because the masks fold by rank (ROADMAP, documented
divergences), and fp32 because bf16 rounds a rank's half-batch products
otherwise than the whole batch's (the losses part after the first step).
Every logged loss: TrainConfig is made with log_every 1 (the pipeline
logs every 5 steps, after its last). The rank bodies live here, so the
file imports no JAX: a rank imports it to unpickle its body.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import torch.distributed as dist

from mmd_tpu_torch.parallel.launch import on_rank0, spawn
from mmd_tpu_torch.pipelines import run_all as RA

torch.set_num_threads(2)

WORLD = 2
ARGS = ["--synthetic", "16", "--tiny", "--epochs", "2", "--batch_size", "8",
        "--device", "cpu"]
LR, STEPS = 1e-3, 4                  # 13 train rows, batches of 6, 2 epochs
LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=STEPS * LR)
# what the training writes, held at the limits above; the timings
RESULTS = ("results/eval.csv", "results/metrics.jsonl",
           f"results/checkpoints/step_{STEPS}.pt", "timings.json")


def _forcing(cls, **forced):
    """cls, with `forced` taking the place of what a caller passes."""
    def make(*args, **kw):
        return cls(*args, **{**kw, **forced})
    return make


def _configs(exact=False, setattr_=setattr) -> None:
    """TrainConfig logs every step; with `exact` ModelConfig is fp32 at
    dropout 0."""
    from mmd_tpu_torch.core import config as CF
    setattr_(CF, "TrainConfig", _forcing(CF.TrainConfig, log_every=1))
    if exact:
        setattr_(CF, "ModelConfig", _forcing(
            CF.ModelConfig, dropout=0.0, compute_dtype="float32"))


def _argv(root: Path) -> list:
    return ARGS + ["--root", str(root), "--timings_json",
                   str(root / "timings.json")]


def _params(out: dict) -> dict:
    return {k: v.detach().clone() for k, v in
            out["params"].state_dict().items()}


def _losses(root: Path) -> list:
    return [json.loads(x)["train/total_loss"] for x in
            (root / "results" / "metrics.jsonl").read_text().splitlines()]


def _eval(root: Path) -> pd.DataFrame:
    return pd.read_csv(root / "results" / "eval.csv").drop(
        columns=["timestamp"])


def _files(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


class _Writes:
    """The files this process opens for writing or renames into place,
    from an audit hook (which stays for the life of the process: a
    spawned rank's)."""

    WRITE = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND

    def __init__(self):
        self.paths: list[str] = []
        sys.addaudithook(self._hook)

    def _hook(self, event, args):
        if event == "open":
            path, mode, flags = args
            if isinstance(path, int):
                return
            if (any(c in mode for c in "wax+") if isinstance(mode, str)
                    else bool((flags or 0) & self.WRITE)):
                self.paths.append(os.path.abspath(os.fspath(path)))
        elif event in ("os.rename", "os.replace"):
            self.paths.append(os.path.abspath(os.fspath(args[1])))

    def under(self, root: Path) -> set:
        root = os.path.abspath(root)
        return {os.path.relpath(p, root) for p in self.paths
                if p.startswith(root + os.sep)}


def _fail():
    raise OSError("disk full")


def _rank(rank, world, dev, job):
    """One rank of the world: run_all in fp32 at dropout 0, then --fused,
    then on_rank0 over a call that raises."""
    writes = _Writes()
    _configs(exact=True)
    root = Path(job["root"])
    out = RA.main(_argv(root))
    got = {"jax_loaded": "jax" in sys.modules, "params": _params(out),
           "stages": sorted(out["stages"].summary()),
           "metrics": out["metrics"], "writes": writes.under(root)}
    try:
        RA.main(["--fused", *_argv(Path(job["fused_root"]))])
        got["fused"] = None
    except ValueError as e:
        got["fused"] = str(e)
    got["fused_writes"] = writes.under(Path(job["fused_root"]))
    try:
        on_rank0(_fail)
    except (OSError, RuntimeError) as e:
        got["on_rank0"] = f"{type(e).__name__}: {e}"
    return got


def _single(root: Path, exact=False) -> dict:
    """The single-device run (no process group) with the test's configs;
    MMD_TPU_ROOT restored after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMD_TPU_ROOT", "")
        _configs(exact, mp.setattr)
        out = RA.main(_argv(root))
    return {"root": root, "params": _params(out), "step": out["state"].step}


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    return _single(tmp_path_factory.mktemp("single"))


@pytest.fixture(scope="module")
def single0(tmp_path_factory):
    return _single(tmp_path_factory.mktemp("single0"), exact=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    base = tmp_path_factory.mktemp("world")
    job = {"root": str(base / "tree"), "fused_root": str(base / "fused")}
    outs = spawn(_rank, WORLD, "gloo", "cpu", args=(job,), timeout_s=600)
    return {"root": base / "tree", "fused_root": base / "fused",
            "outs": outs}


def test_world_of_one_is_the_single_device_run_bit_for_bit(single,
                                                          tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        got = _single(tmp_path / "tree")
    finally:
        dist.destroy_process_group()
    assert got["step"] == single["step"] == STEPS
    assert got["params"].keys() == single["params"].keys()
    for name, want in single["params"].items():
        assert torch.equal(got["params"][name], want), name
    assert _losses(got["root"]) == _losses(single["root"])
    assert len(_losses(single["root"])) == STEPS
    pd.testing.assert_frame_equal(_eval(got["root"]), _eval(single["root"]))


def test_two_ranks_train_as_one_device_in_fp32_at_dropout_0(world,
                                                           single0):
    outs = world["outs"]
    got, want = _losses(world["root"]), _losses(single0["root"])
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    for name, w in single0["params"].items():
        for out in outs:
            np.testing.assert_allclose(out["params"][name].numpy(),
                                       w.numpy(), **PARAM_TOL, err_msg=name)
        assert torch.equal(outs[0]["params"][name], outs[1]["params"][name])
    assert outs[1]["metrics"] is None
    assert set(outs[0]["metrics"]) >= {"unified/accuracy"}
    assert outs[1]["stages"] == ["train"]
    assert set(outs[0]["stages"]) == {
        "synthesize", "preprocess", "assets", "caption", "embed",
        "retrieval_build", "train", "eval", "demo_verify"}


def test_rank0_alone_writes_the_single_device_files(world, single0):
    root, want_root = world["root"], single0["root"]
    files = _files(root)
    assert files == _files(want_root)
    assert world["outs"][1]["writes"] == set()
    written = world["outs"][0]["writes"]
    # every file, and files renamed into place since
    assert files <= written
    assert not any((root / p).exists() for p in written - files)
    for rel in sorted(files - set(RESULTS)):
        got = (root / rel).read_bytes()
        want = (want_root / rel).read_bytes()
        if rel.endswith("ids.json"):          # the paths name the root
            want = want.replace(str(want_root).encode(), str(root).encode())
        assert got == want, rel
    for split, rows in (("train", 16), ("test", 4)):
        meta = json.loads((root / "data" / "preprocessed" /
                           f"{split}_embeddings.store" / "meta.json")
                          .read_text())
        assert meta["extra"] == {"csv_cursor": rows}, split
    ev, ev0 = _eval(root), _eval(want_root)
    assert list(ev["path"]) == list(ev0["path"]) == [
        "text_text", "text_image", "image_text", "image_image", "unified"]
    np.testing.assert_array_equal(ev["n"], ev0["n"])
    ckpt = torch.load(root / RESULTS[2], weights_only=True)
    want = torch.load(want_root / RESULTS[2], weights_only=True)
    assert ckpt["step"] == want["step"] == STEPS
    for name, w in want["params"].items():
        np.testing.assert_allclose(ckpt["params"][name].numpy(), w.numpy(),
                                   **PARAM_TOL, err_msg=name)
    doc, doc0 = (json.loads((r / "timings.json").read_text())
                 for r in (root, want_root))
    assert doc.keys() == doc0.keys()
    assert doc["stages_sec"].keys() == doc0["stages_sec"].keys()
    assert ({k: v for k, v in doc.items() if k not in (
        "args", "stages_sec", "wall_sec_excl_synthesize", "date")}
        == {k: v for k, v in doc0.items() if k not in (
            "args", "stages_sec", "wall_sec_excl_synthesize", "date")})


def test_fused_refuses_a_world_of_two_before_writing(world):
    for out in world["outs"]:
        assert out["fused"] is not None
        assert "pipelines/fused.py" in out["fused"]
        assert "2 ranks" in out["fused"]
        assert out["fused_writes"] == set()
    assert not world["fused_root"].exists()


def test_on_rank0_raises_rank0s_failure_on_every_rank(world):
    assert [out["on_rank0"] for out in world["outs"]] == [
        "OSError: disk full",
        "RuntimeError: rank 0 failed: OSError: disk full"]


def test_ranks_never_load_jax(world):
    assert not any(out["jax_loaded"] for out in world["outs"])
