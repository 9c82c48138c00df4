"""A best_model.pt that the port's trainer wrote, served by
python -m mmd_tpu_torch.evaluate --checkpoint on the CPU over converted
small encoders (a BERT-class text encoder and a ViT with their sidecar
configs, written as mmd_tpu_torch/convert_hf.py writes them). The rest of
the checkpoint slice is in tests/test_torch_checkpoint.py."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from mmd_tpu_torch.convert_hf import write_asset
from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.inference.predictor import MisinformationPredictor
from test_torch_serving import CORPUS

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


def test_port_trained_best_model_serves_through_evaluate(tmp_path):
    """python -m mmd_tpu_torch.train writes best_model.pt; python -m
    mmd_tpu_torch.evaluate --checkpoint serves it over converted small
    encoders (a BERT-class text encoder and a ViT with sidecars), with the
    same result as the predictor in this process and another than the
    seeded head's."""
    from mmd_tpu_torch import train
    from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
    from mmd_tpu_torch.models import text_encoder as tte
    from mmd_tpu_torch.models import vit as tvit

    run = tmp_path / "run"
    train.main(["--device", "cpu", "--synthetic_samples", "4",
                "--batch_size", "4", "--epochs", "1", "--log_every", "1",
                "--compute_dtype", "float32", "--embed_dim", "32",
                "--num_heads", "2", "--hidden_dim", "16",
                "--validate_every_epoch", "--save_best",
                "--output_dir", str(run)])
    best = run / "best_model.pt"
    assert best.exists()

    assets = tmp_path / "assets"
    tok = WordPieceTokenizer.train(CORPUS, 200)
    assets.mkdir()
    tok.save(assets / "tokenizer.json")
    gen = torch.Generator().manual_seed(3)
    text_cfg = dataclasses.replace(tte.TINY_TEST, vocab_size=tok.vocab_size,
                                   hidden_size=384, num_heads=6, num_layers=1,
                                   max_position=512)
    vit_cfg = dataclasses.replace(tvit.VIT_TEST, hidden_size=1024,
                                  num_heads=16, num_layers=1)
    write_asset(assets, "text_encoder", tte.init_text_encoder(gen, text_cfg),
                text_cfg)
    write_asset(assets, "vit", tvit.init_vit(gen, vit_cfg), vit_cfg)

    args = ["--claim_text", CORPUS[0], "--evidence_text", CORPUS[3],
            "--embed_dim", "32", "--num_heads", "2", "--hidden_dim", "16",
            "--detailed"]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "mmd_tpu_torch.evaluate", "--device", "cpu",
         "--assets", str(assets), "--checkpoint", str(best), *args],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert res.returncode == 0, res.stderr
    served = json.loads(res.stdout[:res.stdout.rindex("final:")])

    cfg = ModelConfig(embed_dim=32, num_heads=2, hidden_dim=16)
    direct = MisinformationPredictor(cfg, checkpoint_path=str(best),
                                     assets_dir=str(assets), device="cpu")
    assert isinstance(direct.enc.text_cfg, type(text_cfg))
    assert direct.enc.text_cfg.num_layers == 1
    want = direct.evaluate(CORPUS[0], None, CORPUS[3], None, detailed=True)
    assert served == json.loads(json.dumps(want))
    seeded = MisinformationPredictor(cfg, encoders=direct.enc, device="cpu")
    other = seeded.evaluate(CORPUS[0], None, CORPUS[3], None, detailed=True)
    assert (other["text_text"]["probabilities"]
            != want["text_text"]["probabilities"])
