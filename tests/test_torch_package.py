"""Package guards for the port: mmd_tpu_torch and chip_smoke.py load
neither JAX nor the JAX package (mmd_tpu); the card's machine has no JAX
at all."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "mmd_tpu_torch"


def test_port_imports_leave_jax_out():
    """Every module of the package, imported in a fresh interpreter, keeps
    jax and mmd_tpu out of sys.modules."""
    code = (
        "import pkgutil, sys\n"
        "import mmd_tpu_torch.evaluate, mmd_tpu_torch.inference.server, "
        "mmd_tpu_torch.bridge\n"
        "import mmd_tpu_torch\n"
        "for m in pkgutil.walk_packages(mmd_tpu_torch.__path__, "
        "'mmd_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'mmd_tpu') or "
        "n.startswith(('jax.', 'jaxlib', 'mmd_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("path", ["chip_smoke.py"] + sorted(
    p.relative_to(REPO).as_posix() for p in PKG.rglob("*.py")))
def test_no_jax_import_in_source(path):
    text = (REPO / path).read_text()
    for line in text.splitlines():
        stripped = line.strip()
        assert not stripped.startswith(
            ("import jax", "from jax", "import mmd_tpu.", "import mmd_tpu ",
             "from mmd_tpu.", "from mmd_tpu ")), f"{path}: {stripped}"


def _swin_test_tree():
    import jax
    import numpy as np

    from mmd_tpu.models import swin as JS
    return jax.tree_util.tree_map(
        np.asarray, JS.init_swin(jax.random.key(0), JS.SWIN_TEST))


def _swin_test_cfg():
    import dataclasses

    from mmd_tpu.models import swin as JS
    from mmd_tpu_torch.models import swin as TS
    return TS.SwinConfig(**dataclasses.asdict(JS.SWIN_TEST))


def test_bridge_refuses_swin_tree_with_bias_on_k():
    """Swinv2's key projection has no bias: a tree that gives it one is
    not the model the port builds."""
    import numpy as np

    from mmd_tpu_torch import bridge

    tree = _swin_test_tree()
    blk = tree["stages"][0]["blocks"][1]
    blk["k"] = dict(blk["k"], b=np.zeros(blk["k"]["w"].shape[1], np.float32))
    with pytest.raises(KeyError, match=r"blocks\[1\]\.k.*\['b'\]"):
        bridge.swin_from_jax(tree, _swin_test_cfg())


def test_bridge_refuses_swin_tree_with_missing_key():
    from mmd_tpu_torch import bridge

    tree = _swin_test_tree()
    del tree["stages"][0]["downsample"]["reduction"]
    with pytest.raises(KeyError, match="reduction"):
        bridge.swin_from_jax(tree, _swin_test_cfg())
    tree = _swin_test_tree()
    del tree["stages"][1]["blocks"][0]["cpb2"]["w"]
    with pytest.raises(KeyError, match="cpb2"):
        bridge.swin_from_jax(tree, _swin_test_cfg())


def test_bridge_loads_swin_and_deberta_trees():
    """Bias-free projections load from {"w"} alone; every leaf arrives."""
    import dataclasses

    import jax
    import numpy as np

    from mmd_tpu.models import deberta as JD
    from mmd_tpu_torch import bridge
    from mmd_tpu_torch.models import deberta as TD

    tree = _swin_test_tree()
    params = bridge.swin_from_jax(tree, _swin_test_cfg())
    blk = params["stages"][1]["blocks"][1]
    assert blk["k"].bias is None and blk["cpb2"].bias is None
    np.testing.assert_array_equal(
        blk["k"].weight.detach().numpy(),
        tree["stages"][1]["blocks"][1]["k"]["w"].T)
    dtree = jax.tree_util.tree_map(
        np.asarray, JD.init_deberta(jax.random.key(1), JD.DEBERTA_TEST))
    dparams = bridge.deberta_from_jax(
        dtree, TD.DebertaConfig(**dataclasses.asdict(JD.DEBERTA_TEST)))
    np.testing.assert_array_equal(
        dparams["rel_embeddings"].detach().numpy(), dtree["rel_embeddings"])
