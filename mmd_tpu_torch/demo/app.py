"""Streamlit demo shim over ClaimVerificationPipeline (counterpart of
mmd_tpu/demo/app.py).

Parity entry point for `python -m streamlit run src/demo/app.py` (reference
src/demo/app.py:374-525). The heavy lifting lives in demo/pipeline.py (pure,
testable, batched); this file only renders. Streamlit is optional — absent,
the module still imports and `build_pipeline()` remains usable from scripts.

The page's resources are built on the card (`MMD_DEVICE` picks another
device, e.g. `cpu`; build_pipeline takes `device=` from scripts).

Run: python -m streamlit run mmd_tpu_torch/demo/app.py
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.demo.pipeline import ClaimVerificationPipeline, EvidenceIndex
from mmd_tpu_torch.inference.predictor import (
    MisinformationPredictor, resolve_device,
)

CATEGORY_MAPPING = {
    "support": "Support",
    "not_enough_information": "Not Enough Information",
    "refute": "Refute",
    None: "—",
}


@functools.lru_cache(maxsize=1)
def build_pipeline(root: str = ".", checkpoint: str | None = None,
                   assets: str = "assets/encoders",
                   device: str = "cuda") -> ClaimVerificationPipeline:
    """Per-process cache twin of the reference's five cached builders
    (src/demo/app.py:64-90 get_train_df/get_test_df/get_semantic_similarity,
    :166 get_image_corpus, :237 get_predictor — @st.cache_data/resource):
    every resource is constructed once per process and reused across
    Verify-Claim clicks; the lru_cache is keyed the same way streamlit keys
    its caches (by argument values). On the card the fusion model's
    attention takes the kernel where ops/attention.py's routing rule
    sends it."""
    root_p = Path(root)
    dev = resolve_device(device)
    predictor = MisinformationPredictor(
        ModelConfig(fused_attn=dev.type == "cuda"),
        checkpoint_path=checkpoint, assets_dir=assets, device=dev)

    text_search = None
    image_corpus = None
    index = None
    csvs = {}
    for split in ("train", "test"):
        p = root_p / "data" / "preprocessed" / f"{split}_enriched.csv"
        if p.exists():
            csvs[split] = p
    if csvs:
        index = EvidenceIndex(csvs, root=root_p)
        try:
            from mmd_tpu_torch.retrieval.text import SemanticSearch, TextCorpus
            corpora = []
            for split in csvs:
                d = root_p / "data" / "retrieval" / f"text_{split}"
                if (d / "meta.json").exists():
                    corpora.append(TextCorpus(d, predictor.enc.tokenizer,
                                              device=dev))
            if corpora:
                text_search = SemanticSearch(
                    corpora[0], corpora,
                    evidence_lookup=index.text_lookup())
        except Exception as e:
            print(f"[demo] text retrieval unavailable: {e}")
    img_store = root_p / "data" / "retrieval" / "image_corpus"
    if (img_store / "meta.json").exists():
        from mmd_tpu_torch.retrieval.image import ImageCorpus
        image_corpus = ImageCorpus(img_store, device=dev)

    caption_engine = None
    try:
        from mmd_tpu_torch.pipelines.caption import CaptionEngine
        caption_engine = CaptionEngine(predictor.enc.tokenizer, batch_size=1,
                                       device=dev)
    except Exception as e:
        print(f"[demo] captioner unavailable: {e}")

    return ClaimVerificationPipeline(
        predictor, text_search=text_search, image_corpus=image_corpus,
        caption_engine=caption_engine, evidence_index=index)


PATH_LABELS = ("Claim Text | Evidence Text", "Claim Text | Evidence Image",
               "Claim Image | Evidence Text", "Claim Image | Evidence Image")


def _dataset_of(evidence_id: str) -> str:
    return evidence_id.split("_", 1)[0] if "_" in str(evidence_id) else "—"


def display_evidence_tab(st, evidences, tab_label: str) -> None:
    """Per-evidence panel (reference app.py:266-310): subheader, dataset/id,
    image, caption + text areas, then the four per-path classifications and
    the per-evidence final verdict."""
    with st.container():
        for index, ev in enumerate(evidences):
            with st.container():
                st.subheader(f"Evidence {index + 1}")
                st.write(f"Evidence Dataset: {_dataset_of(ev.id)}")
                st.write(f"Evidence ID: {ev.id}")
                if ev.image_path and os.path.exists(str(ev.image_path)):
                    st.image(ev.image_path, width=240)
                st.text_area("Evidence Caption", getattr(ev, "caption", ""),
                             key=f"caption_{tab_label}_{index}")
                st.text_area("Evidence Text", (ev.text or "")[:2000],
                             key=f"text_{tab_label}_{index}")
                st.write("**Classification:**")
                if ev.classification_result_all:
                    for label, verdict in zip(PATH_LABELS,
                                              ev.classification_result_all):
                        st.write(f"{label}: {CATEGORY_MAPPING[verdict]}")
                st.write(f"Final: "
                         f"{CATEGORY_MAPPING[ev.classification_result_final]}"
                         f" (score {ev.score:.3f})")


def render_app(st, pipeline_factory=None) -> None:
    """The full demo page against any streamlit-compatible `st` object
    (reference app.py:374-525 structure: uploader, text area, top-k slider
    columns, five progress-reported steps, Text/Image evidence tabs, final
    combined classification + contributing evidences). Factored from main()
    so tests can drive it with a recording fake `st`."""
    pipeline_factory = pipeline_factory or build_pipeline

    st.title("Multimodal Evidence-Based Misinformation Classification")
    st.write("Upload claims that have image and/or text content to verify.")

    uploaded_image = st.file_uploader("Upload an image (1 max)",
                                      type=["jpg", "jpeg", "png"])
    image_path = None
    if uploaded_image is not None:
        try:
            image_path = os.path.join("/tmp", uploaded_image.name)
            with open(image_path, "wb") as f:
                f.write(uploaded_image.getbuffer())
            st.image(image_path, caption="Uploaded Image",
                     use_container_width=True)
        except Exception as e:
            st.error(f"Failed to display the image: {e}")

    input_text = st.text_area("Enter text (max 4096 characters)", "",
                              max_chars=4096)

    col1, col2 = st.columns(2)
    with col1:
        top_k_text = st.slider("Top-k text evidences", 1, 10, 5)
    with col2:
        top_k_image = st.slider("Top-k image evidences", 1, 10, 5)

    if not st.button("Verify Claim"):
        return
    if not input_text and image_path is None:
        st.warning("Please upload an image or enter text.")
        return

    pipe = pipeline_factory()
    progress = st.progress(0)

    st.write("### Step 1: Generating caption...")
    with st.spinner("Generating caption..."):
        caption = pipe.caption_step(image_path)
    if caption:
        st.write("**Generated Image Caption:**", caption)
    progress.progress(20)

    st.write("### Step 2: Enriching text...")
    enriched_text = pipe.enrich_step(input_text, caption)
    st.write("**Enriched Text:**")
    st.write(enriched_text)
    progress.progress(40)

    st.write("### Step 3: Retrieving evidences by text...")
    with st.spinner("Retrieving evidences by text..."):
        text_evidences = pipe.retrieve_text_step(enriched_text, top_k_text)
    if input_text:
        st.write(f"Retrieved {len(text_evidences)} text evidences.")
    else:
        st.write("Text modality is missing from the input claim!")
    progress.progress(60)

    st.write("### Step 4: Retrieving evidences by image...")
    with st.spinner("Retrieving evidences by image..."):
        image_evidences = pipe.retrieve_image_step(image_path, top_k_image)
    if image_path:
        st.write(f"Retrieved {len(image_evidences)} image evidences.")
    else:
        st.write("Image modality is missing from the input claim!")
    progress.progress(80)

    st.write("### Step 5: Verifying claim with retrieved evidences...")
    with st.spinner("Verifying claim with retrieved evidences..."):
        evidences = text_evidences + image_evidences
        final_classification, contributing_indices = pipe.classify_step(
            enriched_text, image_path, evidences)
    progress.progress(100)

    st.divider()
    st.write("## Results")
    tabs = st.tabs(["Text Evidences", "Image Evidences"])
    with tabs[0]:
        if text_evidences:
            st.write("### Text Evidences")
            display_evidence_tab(st, text_evidences, "text")
        else:
            st.write("Text modality is missing from the input claim!")
    with tabs[1]:
        if image_evidences:
            st.write("### Image Evidences")
            display_evidence_tab(st, image_evidences, "image")
        else:
            st.write("Image modality is missing from the input claim!")

    st.divider()
    st.write("### Final Combined Classification")
    st.write(f"**Classification Result:** "
             f"{CATEGORY_MAPPING[final_classification]}")
    if contributing_indices:
        st.write("**Contributing Evidences:**")
        for index in contributing_indices:
            ev = evidences[index - 1]        # 1-based, reference app.py:513
            if ev.source == "text":
                st.write(f"Text Evidence {index}")
            else:
                st.write(f"Image Evidence {index - len(text_evidences)}")
    else:
        st.write("No evidences contributed to this classification.")


def main():
    import streamlit as st
    render_app(st, functools.partial(
        build_pipeline, device=os.environ.get("MMD_DEVICE", "cuda")))


if __name__ == "__main__":
    main()
