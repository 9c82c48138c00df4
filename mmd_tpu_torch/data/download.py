"""Stage 1: data acquisition (Factify zip, per-row images, optional MOCHEG)
(counterpart of mmd_tpu/data/download.py).

Parity targets:
  * Factify zip via Google Drive, extract, rename factify2/->extracted/ and
    val.csv->test.csv, idempotent skip-if-exists (reference
    src/data_loader/download_data.py:17-69);
  * per-row claim/evidence image downloads to
    images/{split}/{id}_{claim|evidence}.jpg with a thread pool and
    per-category success stats JSON (download_images.py:26-139) — with the
    reference's data race fixed: it mutates one shared stats dict from 10
    threads (:104-135); here each worker returns its own counts and the
    merge is single-threaded;
  * MOCHEG tar.gz with 16 MB chunked streaming + disk-space precheck
    (download_data_mocheg.py:18-59), extracted through tarfile's "data"
    filter (no absolute paths, no links out of the tree).

Every network access goes through an injectable callable, so the logic
runs offline: `fetch(url) -> bytes` for an image, `fetch_file(id, path)`
for the Factify zip (gdown by default) and `stream(url, chunk_bytes) ->
iterable of bytes` for MOCHEG (requests by default). The defaults import
their package only when called. The data tree is the JAX package's, under
the project root (`data/schema.py`).

CLIs:
  python -m mmd_tpu_torch.data.download factify
  python -m mmd_tpu_torch.data.download images [--dataset train|test] [--no-threading]
  python -m mmd_tpu_torch.data.download mocheg --url URL
"""

from __future__ import annotations

import argparse
import io
import json
import shutil
import tarfile
import zipfile
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterable, Optional

import pandas as pd

from mmd_tpu_torch.data.schema import HEADERS, get_project_root

FACTIFY_GDRIVE_ID = "1ig7Ea7HxBJSVo8CCnilBdsgsrzi9kNPE"  # public Factify-2 zip
USER_AGENT = ("Mozilla/5.0 (Macintosh; Intel Mac OS X 10_11_5) "
              "AppleWebKit/537.36 (KHTML, like Gecko) "
              "Chrome/50.0.2661.102 Safari/537.36")


def _default_fetch(url: str, timeout: int = 30) -> bytes:
    import requests
    r = requests.get(url, headers={"User-Agent": USER_AGENT},
                     stream=True, timeout=timeout)
    r.raise_for_status()
    return r.content


def _default_fetch_file(gdrive_id: str, path: Path) -> None:
    import gdown
    gdown.download(id=gdrive_id, output=str(path), quiet=False)


def _default_stream(url: str, chunk_bytes: int) -> Iterable[bytes]:
    import requests
    with requests.get(url, stream=True, timeout=60) as r:
        r.raise_for_status()
        yield from r.iter_content(chunk_size=chunk_bytes)


# ---------------------------------------------------------------------------
# Factify zip
# ---------------------------------------------------------------------------

def download_factify_zip(root: Optional[Path] = None,
                         password: Optional[str] = None,
                         gdrive_id: str = FACTIFY_GDRIVE_ID,
                         fetch_file: Callable[[str, Path], None]
                         = _default_fetch_file) -> Path:
    root = root or get_project_root()
    raw = root / "data" / "raw" / "factify"
    raw.mkdir(parents=True, exist_ok=True)
    zip_path = raw / "factify2.zip"
    if not zip_path.exists():
        fetch_file(gdrive_id, zip_path)
    else:
        print(f"zip already exists: {zip_path}")
    return extract_factify_zip(zip_path, raw, password)


def extract_factify_zip(zip_path: Path, raw_dir: Path,
                        password: Optional[str] = None) -> Path:
    """Extract + normalize names (factify2/->extracted/, val.csv->test.csv).
    Idempotent: skips when extracted/ already holds train.csv+test.csv."""
    extracted = raw_dir / "extracted"
    if (extracted / "train.csv").exists() and (extracted / "test.csv").exists():
        print(f"already extracted: {extracted}")
        return extracted
    with zipfile.ZipFile(zip_path) as zf:
        zf.extractall(raw_dir, pwd=password.encode() if password else None)
    src = raw_dir / "factify2"
    if src.exists():
        if extracted.exists():
            shutil.rmtree(extracted)
        src.rename(extracted)
    extracted.mkdir(exist_ok=True)
    val = extracted / "val.csv"
    if val.exists() and not (extracted / "test.csv").exists():
        val.rename(extracted / "test.csv")
    print(f"extracted to {extracted}")
    return extracted


# ---------------------------------------------------------------------------
# Per-row images
# ---------------------------------------------------------------------------

def download_image(url: str, save_path: str | Path,
                   fetch: Callable[[str], bytes] = _default_fetch) -> bool:
    """Fetch -> RGB-convert -> save. Idempotent skip-if-exists; False on any
    failure (skip-and-count)."""
    save_path = Path(save_path)
    if save_path.exists():
        return True
    try:
        from PIL import Image
        img = Image.open(io.BytesIO(fetch(url))).convert("RGB")
        img.save(save_path)
        return True
    except Exception as e:
        print(f"Failed to download image from {url}: {e}")
        return False


def _process_row(row: dict, images_folder: Path,
                 fetch: Callable[[str], bytes]) -> Counter:
    """One row's downloads -> its OWN stats Counter (no shared mutation)."""
    stats: Counter = Counter()
    category = row.get("category", "Unknown") or "Unknown"
    file_id = str(row["id"])
    for kind, url_key in (("claim", "claim_image"),
                          ("evidence", "evidence_image")):
        stats[f"{category}/total_{kind}"] += 1
        url = row.get(url_key) or ""
        if url and download_image(
                url, images_folder / f"{file_id}_{kind}.jpg", fetch):
            stats[f"successful_{kind}"] += 1
            stats[f"{category}/successful_{kind}"] += 1
    return stats


def download_images(dataset: str, use_threading: bool = True,
                    root: Optional[Path] = None,
                    fetch: Callable[[str], bytes] = _default_fetch,
                    max_workers: int = 10) -> Optional[dict]:
    root = root or get_project_root()
    extraction = root / "data" / "raw" / "factify" / "extracted"
    csv_path = extraction / f"{dataset}.csv"
    images_folder = extraction / "images" / dataset
    if not csv_path.exists():
        print(f"CSV file not found for {dataset}: {csv_path}")
        return None
    images_folder.mkdir(parents=True, exist_ok=True)

    df = pd.read_csv(csv_path, names=HEADERS, header=None, sep="\t",
                     skiprows=1)
    rows = df.to_dict("records")

    if use_threading:
        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            partials = list(ex.map(
                lambda r: _process_row(r, images_folder, fetch), rows))
    else:
        partials = [_process_row(r, images_folder, fetch) for r in rows]

    merged: Counter = Counter()
    for p in partials:
        merged.update(p)

    stats = {
        "successful_claim": merged["successful_claim"],
        "successful_evidence": merged["successful_evidence"],
        "categories": {},
    }
    for key, v in merged.items():
        if "/" in key:
            cat, field = key.split("/", 1)
            stats["categories"].setdefault(cat, {
                "total_claim": 0, "successful_claim": 0,
                "total_evidence": 0, "successful_evidence": 0})[field] = v
    stats_path = extraction / f"{dataset}_image_download_stats.json"
    stats_path.write_text(json.dumps(stats, indent=4))
    print(f"Image download stats saved to {stats_path}")
    return stats


# ---------------------------------------------------------------------------
# MOCHEG
# ---------------------------------------------------------------------------

def check_disk_space(path: Path, required_gb: float = 80.0) -> bool:
    free = shutil.disk_usage(path).free / (1024 ** 3)
    if free < required_gb:
        print(f"insufficient disk space: {free:.1f} GB free, "
              f"{required_gb} GB required")
        return False
    return True


def download_mocheg(url: str, root: Optional[Path] = None,
                    chunk_mb: int = 16, required_gb: float = 80.0,
                    stream: Callable[[str, int], Iterable[bytes]]
                    = _default_stream) -> Optional[Path]:
    root = root or get_project_root()
    out_dir = root / "data" / "raw" / "mocheg"
    out_dir.mkdir(parents=True, exist_ok=True)
    if not check_disk_space(out_dir, required_gb):
        return None
    tar_path = out_dir / "mocheg.tar.gz"
    if not tar_path.exists():
        with open(tar_path, "wb") as f:
            for chunk in stream(url, chunk_mb * 1024 * 1024):
                f.write(chunk)
    with tarfile.open(tar_path) as tf:
        tf.extractall(out_dir, filter="data")
    print(f"MOCHEG extracted to {out_dir}")
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("factify")
    pi = sub.add_parser("images")
    pi.add_argument("--dataset", choices=["train", "test"], default=None)
    pi.add_argument("--no-threading", action="store_true")
    pm = sub.add_parser("mocheg")
    pm.add_argument("--url", required=True)
    args = p.parse_args(argv)

    if args.cmd == "factify":
        download_factify_zip()
    elif args.cmd == "images":
        datasets = [args.dataset] if args.dataset else ["train", "test"]
        for ds in datasets:
            download_images(ds, use_threading=not args.no_threading)
    elif args.cmd == "mocheg":
        download_mocheg(args.url)


if __name__ == "__main__":
    main()
