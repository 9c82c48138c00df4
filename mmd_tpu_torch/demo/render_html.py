"""Static HTML twin of the streamlit demo page (counterpart of
mmd_tpu/demo/render_html.py).

Renders a VerificationResult into a self-contained HTML report with the
same sections as the live app (reference src/demo/app.py:374-525: enriched
claim, Text/Image evidence tabs, per-evidence per-path classifications,
final combined classification + contributing evidences). Lets the demo run
headless — this environment has no streamlit — and gives pipelines an
archivable artifact per verified claim.

CLI (end-to-end on a synthetic tree, tiny seeded models):
    python -m mmd_tpu_torch.demo.render_html --out report.html
        [--root demo_tree] [--device cuda]
"""

from __future__ import annotations

import html
import os
from pathlib import Path

from mmd_tpu_torch.demo.pipeline import VerificationResult

CATEGORY_MAPPING = {
    "support": "Support",
    "not_enough_information": "Not Enough Information",
    "refute": "Refute",
    None: "—",
}
PATH_LABELS = ("Claim Text | Evidence Text", "Claim Text | Evidence Image",
               "Claim Image | Evidence Text", "Claim Image | Evidence Image")

_CSS = """
body { font-family: system-ui, sans-serif; max-width: 900px; margin: 2rem auto; color: #1a1a2e; }
h1 { font-size: 1.5rem; } h2 { border-top: 1px solid #ccc; padding-top: 1rem; }
.verdict { font-size: 1.2rem; padding: .6rem 1rem; border-radius: 8px; display: inline-block; }
.v-support { background: #e2f5e8; } .v-refute { background: #fbe3e4; }
.v-not_enough_information, .v-none { background: #eef0f2; }
.evidence { border: 1px solid #ddd; border-radius: 8px; padding: 1rem; margin: 1rem 0; }
.paths td { padding: .15rem .8rem .15rem 0; } .score { color: #667; }
img.ev { max-width: 240px; display: block; margin: .5rem 0; }
.muted { color: #889; }
"""


def _esc(x) -> str:
    return html.escape(str(x if x is not None else "—"))


def _evidence_block(ev, index: int) -> list[str]:
    dataset = str(ev.id).split("_", 1)[0] if "_" in str(ev.id) else "—"
    out = [f'<div class="evidence"><h3>Evidence {index + 1}</h3>',
           f"<p>Evidence Dataset: {_esc(dataset)}<br>"
           f"Evidence ID: {_esc(ev.id)} "
           f'<span class="score">(score {ev.score:.3f})</span></p>']
    if ev.image_path and os.path.exists(str(ev.image_path)):
        out.append(f'<img class="ev" src="{_esc(ev.image_path)}">')
    out.append(f"<p>{_esc((ev.text or '')[:2000])}</p>")
    if ev.classification_result_all:
        rows = "".join(
            f"<tr><td>{_esc(l)}</td><td><b>"
            f"{_esc(CATEGORY_MAPPING.get(v, v))}</b></td></tr>"
            for l, v in zip(PATH_LABELS, ev.classification_result_all))
        out.append(f'<table class="paths">{rows}</table>')
    final = CATEGORY_MAPPING.get(ev.classification_result_final,
                                 ev.classification_result_final)
    out.append(f"<p>Final: <b>{_esc(final)}</b></p></div>")
    return out


def render_html(result: VerificationResult, out_path: str | Path) -> Path:
    """Write the report; returns the path."""
    text_evs = [e for e in result.evidences if e.source == "text"]
    image_evs = [e for e in result.evidences if e.source == "image"]
    final = result.final_classification
    parts = [
        "<!doctype html><meta charset='utf-8'>",
        f"<style>{_CSS}</style>",
        "<h1>Multimodal Evidence-Based Misinformation Classification</h1>",
        f"<p><b>Claim:</b> {_esc(result.claim)}</p>",
    ]
    if result.caption:
        parts.append(f"<p><b>Generated Image Caption:</b> "
                     f"{_esc(result.caption)}</p>")
    parts.append(f"<p><b>Enriched Text:</b> {_esc(result.claim_enriched)}</p>")

    for label, evs in (("Text Evidences", text_evs),
                       ("Image Evidences", image_evs)):
        parts.append(f"<h2>{label}</h2>")
        if not evs:
            modality = label.split()[0]
            parts.append(f'<p class="muted">{modality} modality is missing '
                         "from the input claim!</p>")
        for i, ev in enumerate(evs):
            parts.extend(_evidence_block(ev, i))

    parts.append("<h2>Final Combined Classification</h2>")
    parts.append(f'<p class="verdict v-{final or "none"}">Classification '
                 f"Result: <b>{_esc(CATEGORY_MAPPING.get(final, final))}"
                 "</b></p>")
    if result.contributing_indices:
        parts.append("<p><b>Contributing Evidences:</b></p><ul>")
        for index in result.contributing_indices:
            ev = result.evidences[index - 1]   # 1-based (reference app.py:513)
            if ev.source == "text":
                parts.append(f"<li>Text Evidence {index}</li>")
            else:
                parts.append(
                    f"<li>Image Evidence {index - len(text_evs)}</li>")
        parts.append("</ul>")
    else:
        parts.append('<p class="muted">No evidences contributed to this '
                     "classification.</p>")

    out_path = Path(out_path)
    out_path.write_text("".join(parts))
    return out_path


def main(argv=None) -> VerificationResult:
    """End-to-end: synthetic tree -> pipeline -> verify one claim -> HTML."""
    import argparse
    import tempfile

    import pandas as pd

    from mmd_tpu_torch.core.config import ModelConfig
    from mmd_tpu_torch.data.synthetic import synthetic_factify_tree
    from mmd_tpu_torch.demo.pipeline import (
        ClaimVerificationPipeline, EvidenceIndex,
    )
    from mmd_tpu_torch.inference.predictor import (
        MisinformationPredictor, resolve_device,
    )
    from mmd_tpu_torch.models.captioner import CAPTIONER_TEST
    from mmd_tpu_torch.models.frozen import load_or_init_frozen
    from mmd_tpu_torch.pipelines.build_retrieval import (
        build_image_corpus, build_text_corpora,
    )
    from mmd_tpu_torch.pipelines.caption import CaptionEngine
    from mmd_tpu_torch.pipelines.preprocess import preprocess_csv
    from mmd_tpu_torch.retrieval.text import SemanticSearch

    tmp = Path(tempfile.gettempdir())
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=str(tmp / "mmd_demo_report.html"))
    p.add_argument("--root", default=str(tmp / "mmd_demo_html"))
    p.add_argument("--claim", default=None)
    p.add_argument("--n", type=int, default=24)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    root = Path(args.root)
    synthetic_factify_tree(root, n_train=args.n, n_test=max(args.n // 4, 4),
                           learnable=True, seed=11)
    os.environ["MMD_TPU_ROOT"] = str(root)
    train_csv = preprocess_csv("train", root)
    test_csv = preprocess_csv("test", root)
    df = pd.read_csv(train_csv)
    texts = (df["claim"].fillna("").astype(str).tolist()
             + df["evidence"].fillna("").astype(str).tolist())
    assets = root / "assets" / "encoders"
    enc = load_or_init_frozen(assets, vocab_texts=texts, tiny=True)

    corpora = build_text_corpora(["train"], enc.tokenizer, root, tiny=True,
                                 device=device)
    image_corpus = build_image_corpus(["train"], root, tiny=True,
                                      device=device)
    index = EvidenceIndex({"train": train_csv}, root=root)
    model = ModelConfig(text_input_dim=enc.text_cfg.hidden_size,
                        image_input_dim=enc.vit_cfg.hidden_size,
                        embed_dim=32, num_heads=4, hidden_dim=16,
                        compute_dtype="float32",
                        fused_attn=device.type == "cuda")
    predictor = MisinformationPredictor(model, encoders=enc, batch_size=8,
                                        device=device)
    pipe = ClaimVerificationPipeline(
        predictor, text_search=SemanticSearch(
            corpora[0], corpora, evidence_lookup=index.text_lookup()),
        image_corpus=image_corpus,
        caption_engine=CaptionEngine(enc.tokenizer, cfg=CAPTIONER_TEST,
                                     batch_size=4, device=device),
        evidence_index=index)

    dft = pd.read_csv(test_csv)
    row = dft.iloc[0]
    claim = args.claim or str(row["claim"])
    img = row["claim_image"]
    img_path = str(root / img) if isinstance(img, str) else None
    result = pipe.verify(claim, img_path, top_k=3)
    out = render_html(result, args.out)
    print(f"[demo] verdict={result.final_classification} "
          f"evidences={len(result.evidences)} -> {out}")
    return result


if __name__ == "__main__":
    main()
