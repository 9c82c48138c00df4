"""Prompting-baseline evaluation CLI (counterpart of
mmd_tpu/baselines/eval_prompting.py).

Runs the kumar_et_al zero-shot protocol (reference
src/baselines/kumar_et_al/eval_bloom.py: prompt -> generate -> keyword
parse -> 3-class P/R/F1) over a preprocessed CSV. The LLM is pluggable:

  --llm stub      deterministic keyword-echo stub (offline CI)
  --llm captioner the IN-TREE decoder LM: the captioner's decoder run
                  text-only (models/captioner.lm_generate), loading
                  <assets>/captioner.pt from pipelines/train_captioner.py
                  when present (seeded init otherwise). Caption-trained
                  weights => honest chance-level fact-check numbers.
  --llm hf:<id>   a HF causal LM when weights/network exist (on the CPU,
                  through transformers, imported only then)

The captioner runs on --device (the card unless asked for the CPU).

Usage: python -m mmd_tpu_torch.baselines.eval_prompting \\
    --csv data/preprocessed/test.csv [--limit 100] [--llm stub] \\
    [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import pandas as pd
import torch

from mmd_tpu_torch.baselines import prompting as P
from mmd_tpu_torch.data import labels as lb
from mmd_tpu_torch.inference.predictor import resolve_device
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models.captioner import (
    first_token_logits, lm_generate, load_captioner_assets,
)
from mmd_tpu_torch.ops.image_ops import (
    load_images_parallel, normalize_on_device,
)
from mmd_tpu_torch.pipelines.caption import image_transform


def _left_padded(tok, prompt: str, plen: int, device) -> tuple:
    """(1, plen) ids and mask of the prompt's last plen tokens, pads
    first."""
    ids, _ = tok.encode(prompt, max_length=512)
    ids = ids[-plen:]   # keep the tail: instruction + answer slot
    row = torch.full((1, plen), tok.pad_id, dtype=torch.long)
    mask = torch.zeros((1, plen), dtype=torch.int32)
    row[0, plen - len(ids):] = torch.tensor(ids)
    mask[0, plen - len(ids):] = 1
    return row.to(device), mask.to(device)


def make_captioner_llm(assets: str, device: str | torch.device = "cuda"):
    """Zero-shot LLM over the IN-TREE decoder LM (the captioner's decoder
    run text-only via models/captioner.lm_generate). With a checkpoint from
    pipelines/train_captioner.py this is the honest offline stand-in for the
    reference's BLOOM (src/baselines/kumar_et_al/eval_bloom.py:31-43): a
    real (if weak, caption-trained) LM scoring real prompts; expect
    chance-level fact-check accuracy."""
    device = resolve_device(device)
    tok, cfg, params = load_captioner_assets(assets, device)
    t_new = max(min(8, cfg.decoder.max_position // 2), 1)
    plen = cfg.decoder.max_position - t_new

    def llm(prompt: str) -> str:
        row, mask = _left_padded(tok, prompt, plen, device)
        out = lm_generate(params, cfg, row, mask, eos_id=tok.sep_id,
                          pad_id=tok.pad_id, max_new_tokens=t_new)
        return tok.decode(out[0].cpu().tolist())

    return llm


def make_lvlm_scorer(assets: str, device: str | torch.device = "cuda"):
    """`score(prompt, image_path=None) -> P(yes)` over the in-tree LVLM (the
    captioner: image encoder + cross-attending decoder). Softmaxes only the
    yes/no entries of the first generated token's logits, the LVLM4FV
    verification primitive (reference LVLM4FV/models.py:60-73), so
    two_level_verify and llm_rerank (prompting.py) run on real in-tree
    weights, with or without the image modality."""
    device = resolve_device(device)
    tok, cfg, params = load_captioner_assets(assets, device)
    plen = cfg.decoder.max_position
    transform = image_transform(cfg)

    def _first_piece(word: str) -> int:
        ids, _ = tok.encode(word)
        return int(ids[1])   # [CLS] piece ... [SEP]

    yes_id, no_id = _first_piece("yes"), _first_piece("no")

    @torch.no_grad()
    def score(prompt: str, image_path: str | None = None) -> float:
        row, mask = _left_padded(tok, prompt, plen, device)
        images = None
        if image_path is not None:
            imgs, _ok = load_images_parallel([image_path], transform, 1)
            images = normalize_on_device(
                torch.from_numpy(imgs).to(device), transform,
                L.dtype_of(cfg.vit.compute_dtype))
        logits = first_token_logits(params, cfg, row, mask, images)[0]
        return P.yes_no_probability({"yes": logits[yes_id].item(),
                                     "no": logits[no_id].item()})

    return score


def make_llm(spec: str, assets: str = "assets/encoders",
             device: str | torch.device = "cuda"):
    if spec == "captioner":
        return make_captioner_llm(assets, device)
    if spec == "stub":
        def stub(prompt: str) -> str:
            # decisive keywords leak from the evidence into the answer:
            # a protocol smoke, not a model
            t = prompt.lower()
            if "refute" in t or "false" in t:
                return "refute"
            if "support" in t or "true" in t:
                return "support"
            return "not enough information"
        return stub
    if spec.startswith("hf:"):
        from transformers import AutoModelForCausalLM, AutoTokenizer
        name = spec[3:]
        tok = AutoTokenizer.from_pretrained(name)
        model = AutoModelForCausalLM.from_pretrained(name)
        model.eval()

        def hf_llm(prompt: str) -> str:
            with torch.no_grad():
                ids = tok(prompt, return_tensors="pt",
                          truncation=True, max_length=1024)
                out = model.generate(**ids, max_new_tokens=64,
                                     do_sample=False)
            return tok.decode(out[0][ids["input_ids"].shape[1]:],
                              skip_special_tokens=True)
        return hf_llm
    raise SystemExit(f"unknown --llm {spec}")


def main(argv=None) -> dict:
    """Returns the report it prints."""
    p = argparse.ArgumentParser()
    p.add_argument("--csv", required=True)
    p.add_argument("--llm", default="stub")
    p.add_argument("--limit", type=int, default=200)
    p.add_argument("--assets", default="assets/encoders",
                   help="captioner assets dir for --llm captioner")
    p.add_argument("--results_json", default="prompting_results.json")
    p.add_argument("--device", type=str, default="cuda",
                   help="where --llm captioner runs")
    args = p.parse_args(argv)

    df = pd.read_csv(args.csv).head(args.limit)
    pairs = list(zip(df["claim"].astype(str), df["evidence"].astype(str)))
    cat_idx = np.array([lb.CATEGORY_TO_IDX.get(c, 2) for c in df["category"]])
    y_true = lb.SIMPLIFIED_TABLE[cat_idx].tolist()

    llm = make_llm(args.llm, assets=args.assets, device=args.device)
    out = P.evaluate_zero_shot(llm, pairs, y_true)
    report = {k: v for k, v in out.items() if k != "predictions"}
    print(json.dumps(report, indent=1))
    with open(args.results_json, "w") as f:
        json.dump({"llm": args.llm, "n": len(pairs), **report}, f, indent=1)
    return report


if __name__ == "__main__":
    main()
