"""Single claim-evidence pair inference CLI (reference evaluate.py parity;
counterpart of the repository's evaluate.py).

  python -m mmd_tpu_torch.evaluate --claim_text "..." --evidence_text "..." \\
      [--claim_image img.jpg] [--evidence_image img.jpg] [--detailed] \\
      [--checkpoint <output_dir>/best_model.pt] [--assets assets/encoders] \\
      [--device cuda|cpu]

  python -m torch.distributed.run --standalone --nproc_per_node N \
      -m mmd_tpu_torch.evaluate --text_parallelism {sp,sp_ring,pp,tp} \
      [--model_parallel M] [--dist_backend nccl|gloo] ...

Prints the per-path labels (text_text, text_image, image_text, image_image)
like the reference's MisinformationPredictor.evaluate (evaluate.py:94-196);
--detailed adds confidence + full probability dicts. --device cuda (the
default) raises when torch sees no CUDA device.

--text_parallelism serves the frozen text encoder over the ranks of a
torch.distributed.run launch, on a (world / M, M) mesh (M the world size
unless --model_parallel says otherwise): every rank computes the same
labels and rank 0 prints them. --dist_backend is nccl on CUDA by default
(one card a rank; more ranks than cards raise) and gloo on the CPU; gloo on
CUDA shares a card between ranks and stages their tensors through host
memory.
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
                   help="serve the frozen text encoder over the ranks of a "
                        "torch.distributed.run launch (Megatron TP / GPipe "
                        "PP / sequence parallel / ring attention)")
    p.add_argument("--model_parallel", type=int, default=0,
                   help="model-axis size for --text_parallelism (default: "
                        "the world size)")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="process-group backend for --text_parallelism "
                        "(default nccl on cuda, gloo on cpu)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on (cuda or cpu)")
    args = p.parse_args(argv)

    from mmd_tpu_torch.core.config import ModelConfig
    from mmd_tpu_torch.inference.predictor import MisinformationPredictor
    from mmd_tpu_torch.inference.rules import get_final_classification

    cfg = ModelConfig(
        text_input_dim=args.text_input_dim,
        image_input_dim=args.image_input_dim, embed_dim=args.embed_dim,
        num_heads=args.num_heads, hidden_dim=args.hidden_dim)
    mesh, rank, own_group = None, 0, False
    if args.text_parallelism:
        import torch.distributed as dist

        from mmd_tpu_torch.core.mesh import make_mesh
        from mmd_tpu_torch.parallel.launch import init_from_env
        own_group = not dist.is_initialized()
        rank, world, dev = init_from_env(args.dist_backend, args.device)
        mesh = make_mesh(model_parallel=args.model_parallel or world,
                         device=dev)
    try:
        predictor = MisinformationPredictor(
            cfg, checkpoint_path=args.checkpoint, assets_dir=args.assets,
            device=args.device, mesh=mesh,
            text_parallelism=args.text_parallelism)
        result = predictor.evaluate(
            args.claim_text, args.claim_image,
            args.evidence_text, args.evidence_image, detailed=args.detailed)
    finally:
        if own_group:
            dist.destroy_process_group()
    if result is None:
        if rank == 0:
            print("evaluation failed")
        raise SystemExit(1)
    if rank != 0:
        return
    print(json.dumps(result, indent=2))
    labels = [
        (result[p]["label"] if isinstance(result[p], dict) else result[p])
        for p in ("text_text", "text_image", "image_text", "image_image")
    ]
    print("final:", get_final_classification(labels))


if __name__ == "__main__":
    main()
