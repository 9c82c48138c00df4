"""Convert the JAX package's orbax checkpoints into the PyTorch port's files.

    python tools/orbax_to_torch.py --assets assets/encoders
    python tools/orbax_to_torch.py --fusion <output_dir>/best_model \\
        [--embed_dim 256 --num_heads 8 ...]

Runs where JAX and orbax are installed; the port (mmd_tpu_torch) never
imports it, and the machine that serves the port needs no JAX.

--assets: each <name>.ckpt of the directory (deberta, swinv2,
text_encoder, vit, and the retrieval encoders bi_encoder, cross_encoder,
resnet50) becomes <name>.pt beside it. The restore template is built from
the sidecar config the JAX converter wrote (<name>_config.json), so layer
lists stay lists; a BERT-class text_encoder.ckpt without one takes the JAX
package's frozen-encoder shape (TEXT_ENCODER_XSMALL at the vocabulary size
of the directory's spm.json or tokenizer.json), vit.ckpt without
vit_config.json the default ViTConfig, and resnet50.ckpt (which the JAX
converter writes without a sidecar) the default ResNetConfig. A
cross_encoder.ckpt is the JAX converter's: backbone, the HF pooler and the
scorer.

--fusion: an orbax best_model (fusion params) becomes best_model.pt
beside it, restored with the ModelConfig given by the flags (one for
each ModelConfig field, defaults as there).

Trees map onto the port's modules through mmd_tpu_torch/bridge.py, which
checks every name and shape; the .pt files are the modules' state dicts
(mmd_tpu_torch.core.checkpoint.save_params), which the port's
models/frozen.py and MisinformationPredictor(checkpoint_path=...) load.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from mmd_tpu.core import config as jconfig  # noqa: E402
from mmd_tpu.core.checkpoint import load_params  # noqa: E402
from mmd_tpu.models import deberta as jdeberta  # noqa: E402
from mmd_tpu.models import fusion as jfusion  # noqa: E402
from mmd_tpu.models import layers as jlayers  # noqa: E402
from mmd_tpu.models import resnet as jresnet  # noqa: E402
from mmd_tpu.models import swin as jswin  # noqa: E402
from mmd_tpu.models import text_encoder as jte  # noqa: E402
from mmd_tpu.models import vit as jvit  # noqa: E402
from mmd_tpu.models.transformer import TransformerConfig as JTransformer  # noqa: E402
from mmd_tpu_torch import bridge  # noqa: E402
from mmd_tpu_torch.core.checkpoint import save_params  # noqa: E402
from mmd_tpu_torch.core.config import ModelConfig  # noqa: E402
from mmd_tpu_torch.data.spm import UnigramTokenizer  # noqa: E402
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer  # noqa: E402
from mmd_tpu_torch.models import deberta as tdeberta  # noqa: E402
from mmd_tpu_torch.models import resnet as tresnet  # noqa: E402
from mmd_tpu_torch.models import swin as tswin  # noqa: E402
from mmd_tpu_torch.models import vit as tvit  # noqa: E402
from mmd_tpu_torch.models.transformer import TransformerConfig  # noqa: E402


def _jax_cross_encoder(key, cfg):
    """The tree tools/convert_hf.py saves for a cross-encoder:
    init_cross_encoder's backbone and scorer, and the HF pooler."""
    k1, k2 = jax.random.split(key)
    return {**jte.init_cross_encoder(k1, cfg),
            "pooler": jlayers.linear_init(k2, cfg.hidden_size,
                                          cfg.hidden_size)}


# asset name -> (JAX config class, JAX init, port config class, bridge map)
ASSETS = {
    "deberta": (jdeberta.DebertaConfig, jdeberta.init_deberta,
                tdeberta.DebertaConfig, bridge.deberta_from_jax),
    "swinv2": (jswin.SwinConfig, jswin.init_swin, tswin.SwinConfig,
               bridge.swin_from_jax),
    "text_encoder": (JTransformer, jte.init_text_encoder, TransformerConfig,
                     bridge.text_encoder_from_jax),
    "vit": (jvit.ViTConfig, jvit.init_vit, tvit.ViTConfig,
            bridge.vit_from_jax),
    "bi_encoder": (JTransformer, jte.init_text_encoder, TransformerConfig,
                   bridge.text_encoder_from_jax),
    "cross_encoder": (JTransformer, _jax_cross_encoder, TransformerConfig,
                      bridge.cross_encoder_from_jax),
    "resnet50": (jresnet.ResNetConfig, jresnet.init_resnet,
                 tresnet.ResNetConfig, bridge.resnet_from_jax),
}


def restore(path: Path, init, cfg):
    """The orbax tree at `path` as numpy leaves, restored onto the shape
    of init(key, cfg)."""
    device = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    template = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=device),
        jax.eval_shape(lambda: init(jax.random.key(0), cfg)))
    return jax.tree_util.tree_map(np.asarray, load_params(str(path),
                                                          template))


def _default_config(assets: Path, name: str, jcls):
    """The shape the JAX package's frozen-encoder resolver gives an asset
    that has no sidecar."""
    if name in ("vit", "resnet50"):
        return jcls()
    if name == "text_encoder":
        if (assets / "spm.json").exists():
            vocab = UnigramTokenizer.load(assets / "spm.json").vocab_size
        else:
            vocab = WordPieceTokenizer.load(
                assets / "tokenizer.json").vocab_size
        return dataclasses.replace(jte.TEXT_ENCODER_XSMALL, vocab_size=vocab)
    raise FileNotFoundError(f"{assets / f'{name}_config.json'} is missing: "
                            f"{name}.ckpt cannot be read without it")


def convert_assets(assets: str | Path) -> list[Path]:
    """Write <name>.pt beside each <name>.ckpt of `assets`."""
    assets = Path(assets)
    written = []
    for name, (jcls, init, tcls, to_port) in ASSETS.items():
        ckpt = assets / f"{name}.ckpt"
        if not ckpt.exists():
            continue
        sidecar = assets / f"{name}_config.json"
        if sidecar.exists():
            jcfg = jcls(**json.loads(sidecar.read_text()))
        else:
            jcfg = _default_config(assets, name, jcls)
        tree = restore(ckpt, init, jcfg)
        params = to_port(tree, tcls(**dataclasses.asdict(jcfg)))
        save_params(str(assets / f"{name}.pt"), params)
        written.append(assets / f"{name}.pt")
        print(f"{ckpt} -> {assets / f'{name}.pt'}")
    return written


def convert_fusion(path: str | Path, model_cfg: ModelConfig) -> Path:
    """Write <path>.pt (best_model -> best_model.pt) from the orbax fusion
    params at `path`."""
    path = Path(path)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(model_cfg))
    tree = restore(path, jfusion.init_fusion_params, jcfg)
    out = path.with_suffix(".pt")
    save_params(str(out), bridge.fusion_from_jax(tree, model_cfg))
    print(f"{path} -> {out}")
    return out


def _model_config_flags(p: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(ModelConfig):
        if isinstance(f.default, bool):
            p.add_argument(f"--{f.name}", action=argparse.BooleanOptionalAction,
                           default=f.default)
        elif isinstance(f.default, (int, float, str)):
            p.add_argument(f"--{f.name}", type=type(f.default),
                           default=f.default)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Convert the JAX package's orbax checkpoints into the "
                    "PyTorch port's .pt files")
    p.add_argument("--assets", type=str, default=None,
                   help="an encoder assets directory with <name>.ckpt")
    p.add_argument("--fusion", type=str, default=None,
                   help="an orbax best_model directory (fusion params)")
    _model_config_flags(p)
    args = p.parse_args(argv)
    if not (args.assets or args.fusion):
        p.error("nothing to convert: pass --assets and/or --fusion")
    jax.config.update("jax_platforms", "cpu")
    if args.assets:
        if not convert_assets(args.assets):
            raise FileNotFoundError(f"no <name>.ckpt under {args.assets}")
    if args.fusion:
        cfg = ModelConfig(**{f.name: getattr(args, f.name)
                             for f in dataclasses.fields(ModelConfig)
                             if hasattr(args, f.name)})
        convert_fusion(args.fusion, cfg)


if __name__ == "__main__":
    main()
