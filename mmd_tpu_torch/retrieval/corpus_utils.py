"""The flat evidence-image corpus directory (the port's copy of
mmd_tpu/retrieval/corpus_utils.py).

Parity with reference src/evidence/corpus_utils.py:7-32: copies every
`images/{split}/{id}_evidence.jpg` into one flat `evidence_corpus/` dir named
`{split}_{id}_evidence.jpg` — the id format the demo's image-retrieval
resolver expects. Also provides the store-key rewriter that replaces the
reference's pickle-key migration tool (:42-86).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Iterable

from mmd_tpu_torch.data.schema import get_project_root


def build_evidence_corpus_dir(
    splits: Iterable[str] = ("train", "test"),
    root: Path | None = None,
    corpus_dir: Path | None = None,
) -> Path:
    root = root or get_project_root()
    corpus_dir = corpus_dir or (root / "data" / "evidence_corpus")
    corpus_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for split in splits:
        src_dir = root / "data" / "raw" / "factify" / "extracted" / "images" / split
        if not src_dir.exists():
            continue
        for p in src_dir.glob("*_evidence.jpg"):
            dst = corpus_dir / f"{split}_{p.name}"
            if not dst.exists():
                shutil.copyfile(p, dst)
            n += 1
    print(f"[corpus] evidence corpus dir: {corpus_dir} ({n} images)")
    return corpus_dir


def rewrite_corpus_ids(store_dir: Path, old_prefix: str, new_prefix: str) -> int:
    """Rewrite the path prefix of every id in an ImageCorpus ids.json
    (migration helper; reference corpus_utils.py:42-86 did this for pickles).
    Returns the number of rewritten ids."""
    ids_path = Path(store_dir) / "ids.json"
    ids = json.loads(ids_path.read_text())
    n = 0
    out = []
    for i in ids:
        if str(i).startswith(old_prefix):
            out.append(new_prefix + str(i)[len(old_prefix):])
            n += 1
        else:
            out.append(i)
    ids_path.write_text(json.dumps(out))
    return n
