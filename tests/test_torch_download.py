"""The port's data acquisition (mmd_tpu_torch/data/download.py) against the
JAX package's (mmd_tpu/data/download.py), offline: the cases of
tests/test_download.py with an injected fake fetch, each run on two copies
of one raw tree, one per package. The image files, the stats JSON and the
renamed CSVs must be byte-identical to the JAX package's. No test touches
the network: the Factify zip and the MOCHEG stream come from injected
callables too, and the CLI runs only where nothing is left to fetch."""

import io
import json
import shutil
import tarfile
import zipfile
import zlib
from pathlib import Path

import numpy as np
import pytest

from mmd_tpu.data import download as jdl
from mmd_tpu_torch.data import download as tdl
from mmd_tpu_torch.data.schema import HEADERS

EXTRACTED = Path("data/raw/factify/extracted")


def make_jpeg_bytes(seed=0):
    from PIL import Image
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
                    ).save(buf, format="JPEG")
    return buf.getvalue()


def fake_fetch(url):
    if "bad" in url:
        raise IOError("404")
    return make_jpeg_bytes(zlib.crc32(url.encode()) % 100)


def _raw_tree(root: Path) -> Path:
    ext = root / EXTRACTED
    ext.mkdir(parents=True)
    rows = [
        ["1", "c1", "http://x/1c.jpg", "e1", "http://x/1e.jpg", "Refute", "[]", "[]"],
        ["2", "c2", "http://x/2c.jpg", "e2", "http://bad/2e.jpg", "Support_Text", "[]", "[]"],
        ["3", "c3", "", "e3", "http://x/3e.jpg", "Support_Text", "[]", "[]"],
        ["4", "c4", "http://x/4c.jpg", "e4", "", "", "[]", "[]"],
    ]
    with open(ext / "train.csv", "w") as f:
        f.write("\t".join(HEADERS) + "\n")
        for r in rows:
            f.write("\t".join(r) + "\n")
    return root


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("threading", [False, True])
def test_download_images_matches_jax(tmp_path, threading):
    ours, theirs = _raw_tree(tmp_path / "t"), _raw_tree(tmp_path / "j")
    got = tdl.download_images("train", use_threading=threading, root=ours,
                              fetch=fake_fetch)
    want = jdl.download_images("train", use_threading=threading,
                               root=theirs, fetch=fake_fetch)
    assert got == want
    assert _files(ours) == _files(theirs)
    img_dir = ours / EXTRACTED / "images/train"
    assert (img_dir / "1_claim.jpg").exists()
    assert not (img_dir / "2_evidence.jpg").exists()   # failed fetch
    assert not (img_dir / "3_claim.jpg").exists()      # empty url
    assert got["successful_claim"] == 3
    assert got["successful_evidence"] == 2
    assert got["categories"]["Support_Text"]["total_claim"] == 2
    saved = json.loads((ours / EXTRACTED /
                        "train_image_download_stats.json").read_text())
    assert saved == got


def test_download_images_without_csv(tmp_path):
    assert tdl.download_images("test", root=_raw_tree(tmp_path),
                               fetch=fake_fetch) is None


def test_download_image_idempotent(tmp_path):
    calls = []

    def fetch(url):
        calls.append(url)
        return make_jpeg_bytes()
    p = tmp_path / "img.jpg"
    assert tdl.download_image("http://x/a.jpg", p, fetch)
    assert tdl.download_image("http://x/a.jpg", p, fetch)  # skip, no refetch
    assert len(calls) == 1
    assert not tdl.download_image("http://bad/b.jpg", tmp_path / "b.jpg",
                                  fake_fetch)


def _zip(path: Path, prefix: str = "factify2/") -> Path:
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr(f"{prefix}train.csv", "id\tclaim\n1\tx\n")
        zf.writestr(f"{prefix}val.csv", "id\tclaim\n2\ty\n")
        zf.writestr(f"{prefix}images/a.txt", "a")
    return path


@pytest.mark.parametrize("prefix", ["factify2/", "extracted/"])
def test_extract_factify_zip_matches_jax(tmp_path, prefix):
    out = {}
    for name, mod in (("t", tdl), ("j", jdl)):
        raw = tmp_path / name
        raw.mkdir()
        zip_path = _zip(raw / "factify2.zip", prefix)
        out[name] = mod.extract_factify_zip(zip_path, raw)
        assert out[name] == raw / "extracted"
        assert (out[name] / "test.csv").exists()      # val.csv renamed
        assert not (out[name] / "val.csv").exists()
        # idempotent second call
        assert mod.extract_factify_zip(zip_path, raw) == out[name]
    assert _files(out["t"]) == _files(out["j"])


def test_download_factify_zip_fetches_once(tmp_path):
    calls = []

    def fetch_file(gdrive_id, path):
        calls.append(gdrive_id)
        _zip(path)
    out = tdl.download_factify_zip(tmp_path, fetch_file=fetch_file)
    assert out == tmp_path / "data/raw/factify/extracted"
    assert calls == [jdl.FACTIFY_GDRIVE_ID]
    assert (out / "train.csv").read_text() == "id\tclaim\n1\tx\n"
    assert tdl.download_factify_zip(tmp_path, fetch_file=fetch_file) == out
    assert len(calls) == 1


def test_check_disk_space(tmp_path):
    assert tdl.check_disk_space(tmp_path, required_gb=0.001)
    assert not tdl.check_disk_space(tmp_path, required_gb=10 ** 9)


def _tar_bytes() -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        data = b"claim,label\nx,1\n" * 1000
        info = tarfile.TarInfo("mocheg/train.csv")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def test_download_mocheg_streams_in_chunks(tmp_path):
    blob = _tar_bytes()
    seen = []

    def stream(url, chunk_bytes):
        seen.append((url, chunk_bytes))
        for i in range(0, len(blob), 1000):
            yield blob[i:i + 1000]
    out = tdl.download_mocheg("http://m/x.tar.gz", tmp_path, chunk_mb=2,
                              required_gb=0.001, stream=stream)
    assert out == tmp_path / "data/raw/mocheg"
    assert seen == [("http://m/x.tar.gz", 2 * 1024 * 1024)]
    assert (out / "mocheg.tar.gz").read_bytes() == blob
    assert (out / "mocheg/train.csv").read_bytes().startswith(b"claim,label")
    # the tarball is kept: a second call extracts without streaming
    assert tdl.download_mocheg("http://m/x.tar.gz", tmp_path,
                               required_gb=0.001, stream=stream) == out
    assert len(seen) == 1


def test_download_mocheg_checks_the_disk_first(tmp_path):
    def stream(url, chunk_bytes):
        raise AssertionError("streamed despite the disk check")
    assert tdl.download_mocheg("http://m/x", tmp_path, required_gb=10 ** 9,
                               stream=stream) is None


def test_cli_offline(tmp_path, monkeypatch, capsys):
    """The CLI where nothing is left to fetch: an extracted tree, and an
    images split without its CSV."""
    root = _raw_tree(tmp_path)
    (root / EXTRACTED / "test.csv").write_text("id\n")
    (root / "data/raw/factify/factify2.zip").write_bytes(b"")
    monkeypatch.setenv("MMD_TPU_ROOT", str(root))
    tdl.main(["factify"])
    assert "already extracted" in capsys.readouterr().out
    (root / EXTRACTED / "test.csv").unlink()
    tdl.main(["images", "--dataset", "test", "--no-threading"])
    assert "CSV file not found" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tdl.main(["mocheg"])                  # --url is required


def test_evidence_corpus_dir_builder(tmp_path):
    from mmd_tpu_torch.retrieval.corpus_utils import build_evidence_corpus_dir
    root = _raw_tree(tmp_path)
    tdl.download_images("train", use_threading=False, root=root,
                        fetch=fake_fetch)
    corpus = build_evidence_corpus_dir(["train"], root=root)
    names = sorted(p.name for p in corpus.glob("*.jpg"))
    assert names == ["train_1_evidence.jpg", "train_3_evidence.jpg"]
    shutil.rmtree(corpus)
