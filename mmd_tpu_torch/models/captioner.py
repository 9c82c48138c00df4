"""Image captioner: ViT encoder + cross-attending text decoder with a
KV-cached greedy decode (counterpart of mmd_tpu/models/captioner.py).

The image is encoded once; each layer's self-attention K and V live in a
static cache, (B, t_max, D) tensors in the compute dtype allocated once a
batch and written in place at the step's position; each decode step is one
forward of the new token. The JAX package runs the loop as one lax.scan;
here it is a Python loop of exactly t_max steps with fixed shapes, in
which the next tokens and the done flags stay on the device: nothing
inside the loop waits for the card. The cross-attention's K and V depend
only on the image, so a decode computes them once a batch and holds them
in the caches (transformer.cross_keys_values) instead of once a step; the
result is the same to the bit.

The LM head is BLIP's prediction head where the params carry one
(params["lm_head"]: dense + exact GELU + LayerNorm, then an output
projection with bias), else the tied word embedding; both in fp32.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from mmd_tpu_torch.core.checkpoint import orbax_error, read_params
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models import vit as V
from mmd_tpu_torch.models.transformer import (
    TransformerConfig, attention_mask_from_ids, causal_mask,
    cross_keys_values, embed, encoder_layer, init_transformer,
)


@dataclasses.dataclass
class CaptionerConfig:
    vit: V.ViTConfig = dataclasses.field(default_factory=V.ViTConfig)
    decoder: TransformerConfig = dataclasses.field(
        default_factory=lambda: TransformerConfig(
            vocab_size=30000, hidden_size=384, num_layers=6, num_heads=6,
            intermediate_size=1536, max_position=64, type_vocab_size=0,
            is_decoder=True, encoder_hidden_size=1024))
    max_caption_len: int = 32


CAPTIONER_TEST = CaptionerConfig(
    vit=V.VIT_TEST,
    decoder=TransformerConfig(
        vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, max_position=16, type_vocab_size=0,
        is_decoder=True, compute_dtype="float32"),
    max_caption_len=8,
)


def config_from_dict(d: Mapping) -> CaptionerConfig:
    """The config of a captioner_config.json (dataclasses.asdict of the JAX
    package's CaptionerConfig, or of this one: the fields are the same)."""
    return CaptionerConfig(vit=V.ViTConfig(**d["vit"]),
                           decoder=TransformerConfig(**d["decoder"]),
                           max_caption_len=d["max_caption_len"])


def _lm_head_init(gen: torch.Generator, dcfg: TransformerConfig
                  ) -> L.ParamTree:
    d, v = dcfg.hidden_size, dcfg.vocab_size
    return L.ParamTree({"transform": L.linear_init(gen, d, d),
                        "ln": L.layernorm_init(d),
                        "decoder_w": L.normal(gen, (v, d), 0.02),
                        "bias": torch.zeros(v)})


def init_captioner(gen: torch.Generator, cfg: CaptionerConfig,
                   lm_head: bool = False) -> L.ParamTree:
    """{"vit", "decoder"}; the LM head is tied to the word embedding. With
    lm_head, BLIP's prediction head too (what a converted BLIP holds)."""
    p = {"vit": V.init_vit(gen, cfg.vit),
         "decoder": init_transformer(gen, cfg.decoder)}
    if lm_head:
        p["lm_head"] = _lm_head_init(gen, cfg.decoder)
    return L.ParamTree(p)


def _decoder_stack(params, dcfg, x, self_mask, enc, cross_mask=None,
                   caches=None):
    new_caches = []
    for i, p in enumerate(params["decoder"]["layers"]):
        cache = caches[i] if caches is not None else None
        x, nc = encoder_layer(p, dcfg, x, self_mask, enc, cross_mask, cache)
        new_caches.append(nc)
    return x, new_caches


def _lm_logits(params, dcfg, hidden: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T, V) fp32 logits."""
    if "lm_head" in params:
        head = params["lm_head"]
        h = L.linear(head["transform"], hidden.float(), torch.float32)
        h = F.gelu(h)
        h = L.layernorm(head["ln"], h, dcfg.layer_norm_eps)
        return h @ head["decoder_w"].float().T + head["bias"].float()
    return hidden.float() @ params["decoder"]["embeddings"]["word"].float().T


def caption_loss(params, cfg: CaptionerConfig, images: torch.Tensor,
                 input_ids: torch.Tensor, attention_mask: torch.Tensor
                 ) -> torch.Tensor:
    """Teacher-forced next-token CE. input_ids: (B, T) with BOS...EOS."""
    dcfg = cfg.decoder
    enc = V.vit_forward(params["vit"], cfg.vit, images)
    t = input_ids.shape[1]
    x = embed(params["decoder"]["embeddings"], dcfg, input_ids)
    self_mask = (causal_mask(t, x.device)
                 + attention_mask_from_ids(attention_mask, t))
    x, _ = _decoder_stack(params, dcfg, x, self_mask, enc)
    logits = _lm_logits(params, dcfg, x)[:, :-1]
    targets = input_ids[:, 1:].long()
    mask = attention_mask[:, 1:].float()
    nll = -torch.log_softmax(logits, dim=-1).gather(
        -1, targets[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _caches(params, dcfg, b: int, t_max: int, device,
            enc: Optional[torch.Tensor] = None) -> list[dict]:
    """One static cache a layer: zeroed (B, t_max, D) K and V in the
    compute dtype, and with `enc` the layer's cross-attention K and V."""
    dtype = L.dtype_of(dcfg.compute_dtype)
    shape = (b, t_max, dcfg.hidden_size)
    caches = []
    for p in params["decoder"]["layers"]:
        c = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device), "idx": 0}
        if enc is not None:
            c.update(cross_keys_values(p, dcfg, enc))
        caches.append(c)
    return caches


@torch.no_grad()
def decode(params, cfg: CaptionerConfig, enc: torch.Tensor, bos_id: int,
           eos_id: int, pad_id: int = 0, max_new_tokens: Optional[int] = None,
           forced: Optional[torch.Tensor] = None):
    """The greedy decode of `generate` from the ViT's states `enc`:
    exactly t_max steps -> ((B, t_max) int64 tokens, pad_id after EOS;
    logits or None).

    With `forced` (B, t_max) token ids, step s reads forced[:, s - 1]
    instead of its own previous token (teacher forcing along one sequence)
    and the (B, t_max, V) fp32 logits of every step are returned too; the
    tokens are still each step's argmax."""
    dcfg = cfg.decoder
    b = enc.shape[0]
    t_max = max_new_tokens or cfg.max_caption_len
    if t_max > dcfg.max_position:
        raise ValueError(f"{t_max} decode steps exceed the decoder's "
                         f"{dcfg.max_position} positions")
    dev = enc.device
    caches = _caches(params, dcfg, b, t_max, dev, enc)
    # step s may read cache rows 0..s
    masks = causal_mask(t_max, dev)[0, 0]
    tokens = torch.full((b, 1), bos_id, dtype=torch.long, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    out = torch.empty((b, t_max), dtype=torch.long, device=dev)
    logits_all = None
    if forced is not None:
        logits_all = torch.empty((b, t_max, dcfg.vocab_size),
                                 dtype=torch.float32, device=dev)
    for pos in range(t_max):
        if forced is not None and pos > 0:
            tokens = forced[:, pos - 1:pos].long()
        h = embed(params["decoder"]["embeddings"], dcfg, tokens,
                  position_offset=pos)
        self_mask = masks[pos][None, None, None, :]
        for i, p in enumerate(params["decoder"]["layers"]):
            h, caches[i] = encoder_layer(p, dcfg, h, self_mask, enc, None,
                                         caches[i])
        logits = _lm_logits(params, dcfg, h)[:, 0]
        if logits_all is not None:
            logits_all[:, pos] = logits
        # torch.argmax returns the first maximum, as jnp.argmax does
        nxt = torch.where(done, pad_id, logits.argmax(-1))
        done = done | (nxt == eos_id)
        out[:, pos] = nxt
        tokens = nxt[:, None]
    return out, logits_all


@torch.no_grad()
def generate(params, cfg: CaptionerConfig, images: torch.Tensor,
             bos_id: int, eos_id: int, pad_id: int = 0,
             max_new_tokens: Optional[int] = None) -> torch.Tensor:
    """Greedy batched decode -> (B, max_new_tokens) int64 token ids (padded
    with pad_id after EOS)."""
    enc = V.vit_forward(params["vit"], cfg.vit, images)
    return decode(params, cfg, enc, bos_id, eos_id, pad_id,
                  max_new_tokens)[0]


def first_token_logits(params, cfg: CaptionerConfig,
                       prompt_ids: torch.Tensor, prompt_mask: torch.Tensor,
                       images: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(B, V) logits of the FIRST generated token for a left-padded prompt,
    optionally conditioned on an image via cross-attention: the LVLM
    yes/no-token scoring primitive (reference LVLM4FV/models.py:60-73
    softmaxes only the yes/no entries of these logits)."""
    dcfg = cfg.decoder
    enc = (V.vit_forward(params["vit"], cfg.vit, images)
           if images is not None else None)
    plen = prompt_ids.shape[1]
    x = embed(params["decoder"]["embeddings"], dcfg, prompt_ids)
    mask = (causal_mask(plen, x.device)
            + attention_mask_from_ids(prompt_mask, plen))
    h, _ = _decoder_stack(params, dcfg, x, mask, enc)
    return _lm_logits(params, dcfg, h)[:, -1]


@torch.no_grad()
def lm_generate(params, cfg: CaptionerConfig, prompt_ids: torch.Tensor,
                prompt_mask: torch.Tensor, eos_id: int, pad_id: int = 0,
                max_new_tokens: Optional[int] = None) -> torch.Tensor:
    """Text-only causal-LM decode: the captioner's decoder WITHOUT
    cross-attention, as a plain left-to-right LM (the zero-shot prompting
    baselines, reference src/baselines/kumar_et_al/eval_bloom.py:44-81).

    prompt_ids/prompt_mask: (B, P) LEFT-padded (pads first, every row ends
    at position P-1). One prefill of the whole prompt fills the caches,
    then the greedy step loop, as in generate(). Returns (B,
    max_new_tokens) int64, pad_id after EOS."""
    dcfg = cfg.decoder
    b, plen = prompt_ids.shape
    t_new = max_new_tokens or cfg.max_caption_len
    total = plen + t_new
    if total > dcfg.max_position:
        raise ValueError(f"prompt {plen} + {t_new} new tokens exceed the "
                         f"decoder's {dcfg.max_position} positions")
    dev = prompt_ids.device
    caches = _caches(params, dcfg, b, total, dev)
    emb = params["decoder"]["embeddings"]

    # prefill: causal + key padding over the whole cache (columns from
    # plen on are unwritten, so masked)
    cols = torch.arange(total, device=dev)
    keymask = F.pad(prompt_mask, (0, t_new)) > 0                 # (B, total)
    causal = cols[None, :] <= torch.arange(plen, device=dev)[:, None]
    ok = causal[None, None] & keymask[:, None, None, :]
    h = embed(emb, dcfg, prompt_ids)
    h, caches = _decoder_stack(params, dcfg, h,
                               torch.where(ok, 0.0, -1e9), None,
                               caches=caches)
    nxt = _lm_logits(params, dcfg, h)[:, -1].argmax(-1)
    out = torch.empty((b, t_new), dtype=torch.long, device=dev)
    out[:, 0] = nxt
    done = nxt == eos_id
    for j, pos in enumerate(range(plen, total - 1), start=1):
        h = embed(emb, dcfg, nxt[:, None], position_offset=pos)
        valid = (((cols <= pos) & keymask)
                 | ((cols >= plen) & (cols <= pos)))
        step_mask = torch.where(valid, 0.0, -1e9)[:, None, None, :]
        for i, p in enumerate(params["decoder"]["layers"]):
            h, caches[i] = encoder_layer(p, dcfg, h, step_mask, None, None,
                                         caches[i])
        nxt = torch.where(done, pad_id,
                          _lm_logits(params, dcfg, h)[:, 0].argmax(-1))
        done = done | (nxt == eos_id)
        out[:, j] = nxt
    return out


# -- BLIP ------------------------------------------------------------------------

def blip_config(vision_cfg: Mapping, text_cfg: Mapping) -> CaptionerConfig:
    """CaptionerConfig mirroring a HF BlipConfig (dict forms of the vision
    and text sub-configs): fp32, captions of up to 64 tokens."""
    vit = V.ViTConfig(
        image_size=vision_cfg["image_size"],
        patch_size=vision_cfg["patch_size"],
        hidden_size=vision_cfg["hidden_size"],
        num_layers=vision_cfg["num_hidden_layers"],
        num_heads=vision_cfg["num_attention_heads"],
        intermediate_size=vision_cfg["intermediate_size"],
        layer_norm_eps=vision_cfg.get("layer_norm_eps", 1e-5),
        pre_ln=True, embed_ln=False, use_cls=True, keep_cls=True,
        compute_dtype="float32")
    dec = TransformerConfig(
        vocab_size=text_cfg["vocab_size"],
        hidden_size=text_cfg["hidden_size"],
        num_layers=text_cfg["num_hidden_layers"],
        num_heads=text_cfg["num_attention_heads"],
        intermediate_size=text_cfg["intermediate_size"],
        max_position=text_cfg["max_position_embeddings"],
        type_vocab_size=0, is_decoder=True,
        encoder_hidden_size=vision_cfg["hidden_size"],
        layer_norm_eps=text_cfg.get("layer_norm_eps", 1e-12),
        compute_dtype="float32")
    return CaptionerConfig(vit=vit, decoder=dec,
                           max_caption_len=min(
                               64, text_cfg["max_position_embeddings"]))


def load_hf_blip_state_dict(state_dict: Mapping, cfg: CaptionerConfig
                            ) -> L.ParamTree:
    """A HF BlipForConditionalGeneration state dict (torch or numpy
    values) as the captioner's params, with BLIP's prediction head
    (params["lm_head"]). Covers the reference's pretrained captioner,
    src/preprocess/caption.py:10-31 (Salesforce/blip-image-captioning-base).
    The vision tower maps through vit.load_hf_blip_vision_state_dict; the
    text decoder is BERT-shaped with a cross-attention a layer. The head's
    output projection is tied to the word embeddings, so a state dict
    written by save_pretrained may leave it out: the word embeddings
    stand in for it then."""
    vit = V.load_hf_blip_vision_state_dict(
        L.HFPrefixed(state_dict, "vision_model."), cfg.vit)
    get = lambda name: L.hf_tensor(state_dict, name)   # noqa: E731
    emb = "text_decoder.bert.embeddings"
    word = get(f"{emb}.word_embeddings.weight")
    out_w = "text_decoder.cls.predictions.decoder.weight"
    tensors = {
        "decoder.embeddings.word": word,
        "decoder.embeddings.position": get(
            f"{emb}.position_embeddings.weight"),
        "lm_head.decoder_w": get(out_w) if out_w in state_dict else word,
        "lm_head.bias": get("text_decoder.cls.predictions.bias"),
        **{f"vit.{k}": t for k, t in vit.state_dict().items()},
        **L.hf_modules(state_dict, {
            "decoder.embeddings.ln": f"{emb}.LayerNorm",
            "lm_head.transform":
                "text_decoder.cls.predictions.transform.dense",
            "lm_head.ln": "text_decoder.cls.predictions.transform.LayerNorm",
        })}
    for i in range(cfg.decoder.num_layers):
        pre = f"text_decoder.bert.encoder.layer.{i}"
        tensors.update(L.hf_modules(state_dict, {
            f"decoder.layers.{i}.{ours}": f"{pre}.{theirs}"
            for ours, theirs in (
                ("q", "attention.self.query"),
                ("k", "attention.self.key"),
                ("v", "attention.self.value"),
                ("attn_out", "attention.output.dense"),
                ("ln1", "attention.output.LayerNorm"),
                ("xq", "crossattention.self.query"),
                ("xk", "crossattention.self.key"),
                ("xv", "crossattention.self.value"),
                ("xattn_out", "crossattention.output.dense"),
                ("ln_x", "crossattention.output.LayerNorm"),
                ("ffn_in", "intermediate.dense"),
                ("ffn_out", "output.dense"),
                ("ln2", "output.LayerNorm"))}))
    params = init_captioner(torch.Generator().manual_seed(0), cfg,
                            lm_head=True)
    return L.load_tensors(params, tensors, "captioner")


# -- assets ----------------------------------------------------------------------

def load_captioner_assets(assets, device: str | torch.device = "cuda"
                          ) -> tuple:
    """(tokenizer, cfg, params on `device`) from an assets dir holding
    tokenizer.json and optionally captioner.pt + captioner_config.json
    (written by pipelines/train_captioner.py, convert_hf.py --blip or
    tools/orbax_to_torch.py). Seeded init when there is no checkpoint; an
    orbax captioner.ckpt without its .pt raises and names
    tools/orbax_to_torch.py."""
    a = Path(assets)
    tok = WordPieceTokenizer.load(a / "tokenizer.json")
    cfg_path = a / "captioner_config.json"
    if cfg_path.exists():
        cfg = config_from_dict(json.loads(cfg_path.read_text()))
    else:
        cfg = dataclasses.replace(
            CAPTIONER_TEST,
            decoder=dataclasses.replace(CAPTIONER_TEST.decoder,
                                        vocab_size=tok.vocab_size))
    pt, ckpt = a / "captioner.pt", a / "captioner.ckpt"
    if pt.exists():
        state = read_params(pt)
        params = init_captioner(torch.Generator().manual_seed(0), cfg,
                                lm_head=any(k.startswith("lm_head.")
                                            for k in state))
        params.load_state_dict(state)
        print(f"[captioner] weights from {pt}")
    elif ckpt.exists():
        raise orbax_error(ckpt, pt)
    else:
        params = init_captioner(torch.Generator().manual_seed(21), cfg)
        print("[captioner] no captioner.pt: seeded-init weights")
    return tok, cfg, params.to(device)
