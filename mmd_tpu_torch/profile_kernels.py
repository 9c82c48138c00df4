"""What the port's kernels cost beyond their CUDA-event times.

    python -m mmd_tpu_torch.profile_kernels ptxas [SOURCE.cu ...]
    python -m mmd_tpu_torch.profile_kernels flash_calls

`ptxas` compiles sources under ops/csrc/ (all of them by default) with the
build's flags plus `-Xptxas -v` and prints one JSON line a kernel
instantiation: registers, stack frame and spill bytes. It needs nvcc, not
a card.

`flash_calls` times the flash-attention forward at the served batch's six
geometries (batch 16, bf16): microseconds a wrapper call on the host clock
(2000 calls ended by one device sync: the larger of the host's cost of a
call and the kernel's) beside the kernel's device microseconds a launch
(torch.profiler over 200 calls). Where the first is the larger, a run of
calls timed with CUDA events measures the host, not the kernel. It needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from mmd_tpu_torch import profiling as P
from mmd_tpu_torch.ops import cuda_build

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")

# (name, T, S, D, heads, masked): the flash forwards of a served batch
SERVE_GEOMETRIES = [("text", 512, 512, 384, 6, True),
                    ("vit", 64, 64, 1024, 16, False),
                    ("fusion_512x512", 512, 512, 256, 8, False),
                    ("fusion_512x64", 512, 64, 256, 8, False),
                    ("fusion_64x512", 64, 512, 256, 8, False),
                    ("fusion_64x64", 64, 64, 256, 8, False)]
BATCH = 16


def parse_ptxas(log: str) -> list[dict]:
    """One record a kernel from `nvcc -Xptxas -v` output: its mangled
    symbol, registers, stack frame and spill bytes."""
    out, cur = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def _demangle(names: list[str]) -> list[str]:
    try:
        res = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return names
    lines = res.stdout.splitlines()
    return lines if res.returncode == 0 and len(lines) == len(names) \
        else names


def ptxas(sources: list[str]) -> None:
    nvcc = cuda_build.find_nvcc()
    with tempfile.TemporaryDirectory(prefix="mmd_ptxas_") as tmp:
        procs = {src: subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / f"{Path(src).stem}.so"),
             str(cuda_build.CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in sources}            # one nvcc a source, all at once
        for src, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed on {src}:\n{log}")
            recs = parse_ptxas(log)
            for rec, name in zip(recs, _demangle([r["kernel"]
                                                  for r in recs])):
                print(json.dumps({"source": src, **rec, "kernel": name}),
                      flush=True)


def flash_calls() -> None:
    from mmd_tpu_torch.ops import attention as A
    if not torch.cuda.is_available():
        raise SystemExit("flash_calls needs a CUDA device")
    print(json.dumps({"card": P.card()}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, t, s, d, h, masked in SERVE_GEOMETRIES:
        q, k, v = (torch.randn(BATCH, n, d, device=dev, generator=gen)
                   .to(torch.bfloat16) for n in (t, s, s))
        mask = None
        if masked:                          # the tokenizer's int mask
            lengths = torch.linspace(1, s, BATCH, device=dev).round()
            mask = (torch.arange(s, device=dev)[None]
                    < lengths[:, None]).long()
        call = lambda: A.flash_attention(q, k, v, h, mask)  # noqa: E731
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            call()
        torch.cuda.synchronize()
        host_us = (time.perf_counter() - t0) / 2000 * 1e6
        win = P.profile_window(call, 200, {"flash_fwd_kernel": "flash"})
        print(json.dumps({
            "geometry": name, "B": BATCH, "T": t, "S": s, "D": d, "H": h,
            "host_us_a_call": host_us,
            "kernel_device_us_a_launch": win["kernels_ms"]["flash"] * 1e3
            / 200, "card": P.card()}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    sub.add_parser("ptxas").add_argument("sources", nargs="*")
    sub.add_parser("flash_calls")
    args = ap.parse_args(argv)
    if args.what == "ptxas":
        ptxas(args.sources or sorted(f.name for f in cuda_build.CSRC.glob(
            "*.cu")))
    else:
        flash_calls()


if __name__ == "__main__":
    main()
