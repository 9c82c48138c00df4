"""Single claim-evidence pair inference CLI (reference evaluate.py parity;
counterpart of the repository's evaluate.py).

  python -m mmd_tpu_torch.evaluate --claim_text "..." --evidence_text "..." \\
      [--claim_image img.jpg] [--evidence_image img.jpg] [--detailed] \\
      [--checkpoint <output_dir>/best_model.pt] [--assets assets/encoders] \\
      [--device cuda|cpu]

Prints the per-path labels (text_text, text_image, image_text, image_image)
like the reference's MisinformationPredictor.evaluate (evaluate.py:94-196);
--detailed adds confidence + full probability dicts. --device cuda (the
default) raises when torch sees no CUDA device.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate one claim-evidence pair")
    p.add_argument("--claim_text", required=True)
    p.add_argument("--evidence_text", required=True)
    p.add_argument("--claim_image", type=str, default=None)
    p.add_argument("--evidence_image", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="fusion params to serve: <output_dir>/best_model.pt "
                        "of python -m mmd_tpu_torch.train, or the .pt that "
                        "tools/orbax_to_torch.py writes beside a JAX "
                        "best_model; omitted, a seeded init")
    p.add_argument("--assets", type=str, default="assets/encoders")
    p.add_argument("--detailed", action="store_true")
    p.add_argument("--text_input_dim", type=int, default=384)
    p.add_argument("--image_input_dim", type=int, default=1024)
    p.add_argument("--embed_dim", type=int, default=256)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--text_parallelism", choices=["tp", "pp", "sp", "sp_ring"],
                   default=None,
                   help="multi-device text encoding (not ported yet; raises)")
    p.add_argument("--model_parallel", type=int, default=0,
                   help="model-axis size for --text_parallelism")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on (cuda or cpu)")
    args = p.parse_args(argv)
    if args.text_parallelism:
        raise NotImplementedError(
            "--text_parallelism arrives with the multi-device slice")

    from mmd_tpu_torch.core.config import ModelConfig
    from mmd_tpu_torch.inference.predictor import MisinformationPredictor
    from mmd_tpu_torch.inference.rules import get_final_classification

    cfg = ModelConfig(
        text_input_dim=args.text_input_dim,
        image_input_dim=args.image_input_dim, embed_dim=args.embed_dim,
        num_heads=args.num_heads, hidden_dim=args.hidden_dim)
    predictor = MisinformationPredictor(
        cfg, checkpoint_path=args.checkpoint, assets_dir=args.assets,
        device=args.device)
    result = predictor.evaluate(
        args.claim_text, args.claim_image,
        args.evidence_text, args.evidence_image, detailed=args.detailed)
    if result is None:
        print("evaluation failed")
        raise SystemExit(1)
    print(json.dumps(result, indent=2))
    labels = [
        (result[p]["label"] if isinstance(result[p], dict) else result[p])
        for p in ("text_text", "text_image", "image_text", "image_image")
    ]
    print("final:", get_final_classification(labels))


if __name__ == "__main__":
    main()
