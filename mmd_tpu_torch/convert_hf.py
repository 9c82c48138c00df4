"""Convert a local HF model directory into the port's encoder assets
(counterpart of tools/convert_hf.py), with neither transformers nor JAX.

    python -m mmd_tpu_torch.convert_hf --text <hf dir> --image <hf dir> \\
        [--bi_encoder <hf dir>] [--cross_encoder <hf dir>] \\
        [--resnet <torchvision state dict>] --out assets/encoders

A HF model directory is what `save_pretrained` writes or a hub download
holds: config.json and the weights as model.safetensors (read here with
the standard library: a JSON header, then the raw buffers) or
pytorch_model.bin (torch.load, weights only). The family comes from
config.json's model_type:

  deberta-v2  deberta.pt + deberta_config.json, and spm.json from the
              directory's spm.model (the vocabulary DebertaV2Tokenizer
              reads; data/spm.py reproduces its ids)
  bert        text_encoder.pt + text_encoder_config.json, and
              tokenizer.json from vocab.txt when it holds the WordPiece
              specials
  swinv2      swinv2.pt + swinv2_config.json
  vit         vit.pt + vit_config.json
  mpnet       the retrieval bi-encoder (--text or --bi_encoder):
              bi_encoder.pt + bi_encoder_config.json, and bi_tokenizer.json
              from vocab.txt with the RoBERTa-style specials renamed to
              the WordPiece ones (<s> [CLS], </s> [SEP], <pad> [PAD],
              <unk> [UNK], <mask> [MASK]), as tools/convert_hf.py renames
              them

--cross_encoder takes a BertForSequenceClassification directory (the
ms-marco MiniLM packaging): cross_encoder.pt (backbone, pooler, scorer) +
cross_encoder_config.json. --resnet takes a torchvision resnet50 state
dict saved with torch.save: resnet50.pt, its BN statistics folded (no
sidecar: the retrieval code builds ResNetConfig()).

The task wrapper's prefix (deberta., bert., swinv2., vit., mpnet.) is
stripped. Heads the encoder does not run (lm_predictions,
mask_predictions, lm_head, cls, classifier, pooler, torchvision's fc) and
buffers it recomputes (Swinv2's relative_coords_table and
relative_position_index, position_ids, num_batches_tracked) are skipped;
any other key the encoder does not read raises, as does a key it needs
that the file lacks. The .pt files are the modules' state dicts
(core/checkpoint.save_params), which models/frozen.py loads. The sidecars
hold the config dataclass's fields, which are those of the JAX package's
config of the same name: a converted DeBERTa stays float32, as the JAX
package's converter leaves it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import struct
from pathlib import Path
from typing import Mapping, Optional

import torch

from mmd_tpu_torch.core.checkpoint import save_params
from mmd_tpu_torch.data.spm import UnigramTokenizer
from mmd_tpu_torch.data.tokenizer import SPECIALS, WordPieceTokenizer
from mmd_tpu_torch.models import deberta as D
from mmd_tpu_torch.models import resnet as R
from mmd_tpu_torch.models import swin as SW
from mmd_tpu_torch.models import text_encoder as te
from mmd_tpu_torch.models import vit as V

TEXT_FAMILIES = ("deberta-v2", "bert", "mpnet")
IMAGE_FAMILIES = ("swinv2", "vit")
_PREFIX = {"deberta-v2": "deberta.", "bert": "bert.", "swinv2": "swinv2.",
           "vit": "vit.", "mpnet": "mpnet."}
_SKIPPED_HEADS = ("lm_predictions.", "mask_predictions.", "lm_head.",
                  "cls.", "classifier.", "pooler.", "fc.")
_SKIPPED_BUFFERS = ("relative_coords_table", "relative_position_index",
                    "position_ids", "num_batches_tracked")
# the MPNet tokenizer's RoBERTa-style specials -> the WordPiece names
_MPNET_SPECIALS = {"<pad>": "[PAD]", "<unk>": "[UNK]", "<s>": "[CLS]",
                   "</s>": "[SEP]", "<mask>": "[MASK]"}

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """A .safetensors file: <u64 LE header size> <JSON header: name ->
    {dtype, shape, data_offsets}> <buffers>."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        buf = bytearray(data[base + lo:base + hi])     # aligned, writable
        flat = (torch.frombuffer(buf, dtype=dtype) if buf
                else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def read_state_dict(hf_dir: str | Path) -> dict[str, torch.Tensor]:
    hf_dir = Path(hf_dir)
    if (hf_dir / "model.safetensors").exists():
        return read_safetensors(hf_dir / "model.safetensors")
    if (hf_dir / "pytorch_model.bin").exists():
        return torch.load(hf_dir / "pytorch_model.bin", map_location="cpu",
                          weights_only=True)
    raise FileNotFoundError(f"{hf_dir} holds neither model.safetensors nor "
                            f"pytorch_model.bin")


class _Reads(dict):
    """A state dict that records the names read from it."""

    def __init__(self, items):
        super().__init__(items)
        self.read: set[str] = set()

    def __getitem__(self, name):
        self.read.add(name)
        return super().__getitem__(name)


def _skipped(name: str) -> bool:
    return (name.startswith(_SKIPPED_HEADS)
            or name.rsplit(".", 1)[-1] in _SKIPPED_BUFFERS)


def encoder_state_dict(state_dict: Mapping, model_type: str) -> _Reads:
    """The state dict without the task wrapper's prefix, recording reads."""
    prefix = _PREFIX.get(model_type, "")
    if prefix and any(k.startswith(prefix) for k in state_dict):
        state_dict = {k[len(prefix):] if k.startswith(prefix) else k: v
                      for k, v in state_dict.items()}
    return _Reads(state_dict)


def _check_all_read(sd: _Reads, where: Path) -> None:
    unread = sorted(k for k in sd if k not in sd.read and not _skipped(k))
    if unread:
        raise ValueError(f"{where}: the encoder does not read {unread}")


def write_asset(out: str | Path, name: str, params: torch.nn.Module,
                cfg=None) -> None:
    """<out>/<name>.pt, the module's state dict, and with a config its
    sidecar <out>/<name>_config.json."""
    out = Path(out)
    save_params(str(out / f"{name}.pt"), params)
    if cfg is not None:
        (out / f"{name}_config.json").write_text(
            json.dumps(dataclasses.asdict(cfg), indent=1))


def _wordpiece_vocab(hf_dir: Path,
                     rename: Optional[Mapping[str, str]] = None
                     ) -> Optional[WordPieceTokenizer]:
    vocab = (hf_dir / "vocab.txt").read_text(encoding="utf-8")
    rename = rename or {}
    tokens = [rename.get(t, t) for t in
              (t.rstrip("\r") for t in vocab.split("\n"))]
    if tokens and tokens[-1] == "":
        tokens.pop()
    if not all(s in tokens for s in SPECIALS):
        return None
    return WordPieceTokenizer(tokens)


def convert(hf_dir: str | Path, out: str | Path,
            families: tuple[str, ...] = TEXT_FAMILIES + IMAGE_FAMILIES
            ) -> str:
    """Convert one HF model directory into `out`; returns its model_type."""
    hf_dir, out = Path(hf_dir), Path(out)
    config = json.loads((hf_dir / "config.json").read_text())
    model_type = config.get("model_type")
    if model_type not in families:
        raise ValueError(f"{hf_dir}: model_type {model_type!r} is not one "
                         f"of {list(families)}")
    out.mkdir(parents=True, exist_ok=True)
    sd = encoder_state_dict(read_state_dict(hf_dir), model_type)
    if model_type == "deberta-v2":
        cfg = D.config_from_hf(config)
        params = D.load_hf_deberta_state_dict(sd, cfg)
        tok = UnigramTokenizer.from_spm_model(
            (hf_dir / "spm.model").read_bytes())
        _check_all_read(sd, hf_dir)
        write_asset(out, "deberta", params, cfg)
        tok.save(out / "spm.json")
        print(f"deberta: {hf_dir} -> {out}/deberta.pt ({cfg.num_layers}L, "
              f"{cfg.hidden_size}d, buckets {cfg.position_buckets}); "
              f"spm.json ({len(tok.pieces)} pieces)")
    elif model_type == "bert":
        cfg = te.config_from_hf(config)
        params = te.load_hf_state_dict(sd, cfg)
        tok = _wordpiece_vocab(hf_dir)
        _check_all_read(sd, hf_dir)
        write_asset(out, "text_encoder", params, cfg)
        print(f"text encoder: {hf_dir} -> {out}/text_encoder.pt "
              f"({cfg.num_layers}L, {cfg.hidden_size}d)")
        if tok is None:
            print("tokenizer.json not written: vocab.txt lacks the "
                  "WordPiece specials; train one from the corpus instead")
        else:
            tok.save(out / "tokenizer.json")
            print(f"tokenizer.json ({tok.vocab_size} tokens)")
    elif model_type == "mpnet":
        cfg = te.mpnet_config_from_hf(config)
        params = te.load_hf_mpnet_state_dict(sd, cfg)
        tok = _wordpiece_vocab(hf_dir, _MPNET_SPECIALS)
        _check_all_read(sd, hf_dir)
        write_asset(out, "bi_encoder", params, cfg)
        print(f"bi-encoder: {hf_dir} -> {out}/bi_encoder.pt "
              f"({cfg.num_layers}L, {cfg.hidden_size}d, mpnet arch)")
        if tok is None:
            print("bi_tokenizer.json not written: vocab.txt lacks the "
                  "specials")
        else:
            tok.save(out / "bi_tokenizer.json")
            print(f"bi_tokenizer.json ({tok.vocab_size} tokens)")
    elif model_type == "swinv2":
        cfg = SW.config_from_hf(config)
        params = SW.load_hf_swinv2_state_dict(sd, cfg)
        _check_all_read(sd, hf_dir)
        write_asset(out, "swinv2", params, cfg)
        print(f"swinv2: {hf_dir} -> {out}/swinv2.pt (depths {cfg.depths}, "
              f"{cfg.hidden_size}d, {cfg.num_tokens} tokens)")
    else:
        cfg = V.config_from_hf(config)
        params = V.load_hf_vit_state_dict(sd, cfg)
        _check_all_read(sd, hf_dir)
        write_asset(out, "vit", params, cfg)
        print(f"vit: {hf_dir} -> {out}/vit.pt ({cfg.num_layers}L, "
              f"{cfg.hidden_size}d, {cfg.num_tokens} tokens)")
    return model_type


def convert_cross_encoder(hf_dir: str | Path, out: str | Path) -> None:
    """A BertForSequenceClassification directory (one label) ->
    cross_encoder.pt + cross_encoder_config.json."""
    hf_dir, out = Path(hf_dir), Path(out)
    config = json.loads((hf_dir / "config.json").read_text())
    if config.get("model_type") != "bert":
        raise ValueError(f"{hf_dir}: a cross-encoder is a bert "
                         f"BertForSequenceClassification, not "
                         f"{config.get('model_type')!r}")
    out.mkdir(parents=True, exist_ok=True)
    sd = _Reads(read_state_dict(hf_dir))
    cfg = te.config_from_hf(config, cap_positions=False)
    params = te.load_hf_cross_encoder_state_dict(sd, cfg)
    _check_all_read(sd, hf_dir)
    write_asset(out, "cross_encoder", params, cfg)
    print(f"cross-encoder: {hf_dir} -> {out}/cross_encoder.pt "
          f"({cfg.num_layers}L, {cfg.hidden_size}d)")


def convert_resnet(path: str | Path, out: str | Path) -> None:
    """A torchvision resnet50 state dict file (torch.save) ->
    resnet50.pt."""
    path, out = Path(path), Path(out)
    sd = _Reads(torch.load(path, map_location="cpu", weights_only=True))
    params = R.load_torchvision_state_dict(sd, R.ResNetConfig())
    _check_all_read(sd, path)
    out.mkdir(parents=True, exist_ok=True)
    write_asset(out, "resnet50", params)
    print(f"resnet50: {path} -> {out}/resnet50.pt")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Convert local HF model directories into the port's "
                    "encoder assets")
    p.add_argument("--text", type=str, default=None,
                   help="a DeBERTa-v2/v3, BERT or MPNet model directory")
    p.add_argument("--image", type=str, default=None,
                   help="a Swinv2 or ViT model directory")
    p.add_argument("--bi_encoder", type=str, default=None,
                   help="an MPNet model directory (the retrieval "
                        "bi-encoder, e.g. multi-qa-mpnet-base-dot-v1)")
    p.add_argument("--cross_encoder", type=str, default=None,
                   help="a BertForSequenceClassification directory (e.g. "
                        "ms-marco-MiniLM-L-6-v2)")
    p.add_argument("--resnet", type=str, default=None,
                   help="a torchvision resnet50 state dict file")
    p.add_argument("--out", type=str, default="assets/encoders")
    args = p.parse_args(argv)
    if not (args.text or args.image or args.bi_encoder
            or args.cross_encoder or args.resnet):
        p.error("nothing to convert: pass --text, --image, --bi_encoder, "
                "--cross_encoder and/or --resnet")
    if args.text:
        convert(args.text, args.out, TEXT_FAMILIES)
    if args.image:
        convert(args.image, args.out, IMAGE_FAMILIES)
    if args.bi_encoder:
        convert(args.bi_encoder, args.out, ("mpnet",))
    if args.cross_encoder:
        convert_cross_encoder(args.cross_encoder, args.out)
    if args.resnet:
        convert_resnet(args.resnet, args.out)


if __name__ == "__main__":
    main()
