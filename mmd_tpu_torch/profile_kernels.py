"""What the port's kernels cost beyond their CUDA-event times.

    python -m mmd_tpu_torch.profile_kernels ptxas [SOURCE.cu ...]
    python -m mmd_tpu_torch.profile_kernels flash_calls
    python -m mmd_tpu_torch.profile_kernels swin_calls
    python -m mmd_tpu_torch.profile_kernels swin_infer_calls
    python -m mmd_tpu_torch.profile_kernels swin_bwd_calls
    python -m mmd_tpu_torch.profile_kernels deberta_fwd_calls
    python -m mmd_tpu_torch.profile_kernels deberta_bwd_calls
    python -m mmd_tpu_torch.profile_kernels mlp_bwd_calls
    python -m mmd_tpu_torch.profile_kernels mlp_fwd_calls
    python -m mmd_tpu_torch.profile_kernels ln_calls
    python -m mmd_tpu_torch.profile_kernels topk_calls

`ptxas` compiles sources under ops/csrc/ (all of them by default) with the
build's flags plus `-Xptxas -v` and prints one JSON line a kernel
instantiation: registers, stack frame and spill bytes, and one a warning
of ptxas's (C7514: wgmma serialized). It needs nvcc, not
a card.

`flash_calls` times the flash-attention forward at the served batch's six
geometries (batch 16, bf16): microseconds a wrapper call on the host clock
(2000 calls ended by one device sync: the larger of the host's cost of a
call and the kernel's) beside the kernel's device microseconds a launch
(torch.profiler over 200 calls). Where the first is the larger, a run of
calls timed with CUDA events measures the host, not the kernel. It needs
a CUDA device.

`swin_calls` does the same for the Swin fine-tuning forward (#8,
`swin_window_attention_fwd`) at the Swinv2-base stage geometries of a
fine-tuning step (batch 8, bf16), beside one SDPA call that computes the
same function on the same inputs, as chip_smoke.py times it (its host us a
call and its device us, all kernels of the call), a digest of the
forward's output (inputs from a fixed seed: two trees compare bit for
bit), and the device us of the C entry point at each batch split that
divides the batch. It also times each piece of the wrapper's call path alone (2000
calls each), down to the C entry point with its arguments, which launches
the kernel: what is left of a host-bound call past those pieces is
Python's own calls and the launch counter. It needs a CUDA device.

`swin_infer_calls` times the Swin serving kernel (#7,
`swin_window_attention_infer`) at the seven geometries of a served batch of
Swinv2-base (batch 16; unshifted blocks share one bias tile, shifted ones
have one a window), bf16 and fp32: host us a call, the host's own us a call,
the device us a launch (torch.profiler over 50 calls), the us a call by CUDA
events, the wrapper's batch groups, a digest of the output (inputs from a
fixed seed: two trees compare bit for bit), and the device us of the C entry
point itself at each batch split that divides the batch (where the tree's
entry point takes one); then each dtype's device and CUDA-event us summed
over a served batch's 48 calls. It runs on an older tree too, for a
parent/change comparison in one run. It needs a CUDA device.

`swin_bwd_calls` times the Swin fine-tuning backward (#9,
`swin_window_attention_bwd`) at the same four stage geometries, bf16 and
fp32: host us a call, the host's own us a call, the device us of each of
the call's kernel launches and their sum (torch.profiler over 50 calls),
the us a call by CUDA events, and SDPA's backward with the mask's gradient
beside it (CUDA-event and device us a call), as chip_smoke.py times it;
then the device us a call of the C entry point itself at each batch split
that divides the batch (the grid's groups: one launch with one group, a
second that sums dbias with more). Last, the bf16 and fp32 device us summed
over a fine-tuning step's 48 calls. It runs on an older tree too, for a
parent/change comparison in one run. It needs a CUDA device.

The three Swin subcommands run at every window size the tree's wrappers
take: Swinv2-base's four stages at 8 x 8 windows (64 tokens), then its
stages 0-2 at 16 x 16 (256) and 24 x 24 (576) windows, the blocked kernels
(an older tree: 64 tokens only). Each line names its `n`; the sums are a
window size's calls of a served batch or a step (stages 0-2 only above 64
tokens), at the wrapper's split and, where every split is timed, at the
fastest.

`deberta_fwd_calls` times the DeBERTa attention forward (#10,
`deberta_attention`) at the served geometry (B 16, T 512) and the
fine-tuning one (B 8, T 256), D 384, 6 heads, bf16 and fp32: host us a
call, the host's own us a call, the device us of the call's kernel
launches (torch.profiler over 50 calls) and the us a call by CUDA events,
as `deberta_bwd_calls` below takes them. The mask goes in as the encoder
hands it over (bytes made once, where the tree has `key_bytes`; else the
int mask). It runs on an older tree too, for a parent/change comparison in
one run. It needs a CUDA device.

`deberta_bwd_calls` times the DeBERTa attention backward (#11,
`deberta_attention_bwd`) at the fine-tuning geometry (B 8, T 256, D 384,
6 heads; bf16 and fp32): host us a call as `flash_calls` takes it, the
host's own us a call (10 calls enqueued on an idle card, timed before
the device sync; the median of 20 runs) and of the wrapper's input
checks alone, the device us of each of the call's kernel launches and
their sum (torch.profiler over 50 calls), and the us a call by CUDA
events around 20 back-to-back calls, as chip_smoke.py times it. It runs
on an older tree too (its kernels' names are matched whatever they are),
for a parent/change comparison in one run. It needs a CUDA device.

`mlp_bwd_calls` does the same for the fused GELU-MLP backward (#4,
`fused_mlp_bwd`) at the bf16 train step's two MLP geometries (N 131072
and 16384 rows, D 256, F 1024; dropout 0.1): host us a call, the host's
own us a call, the device us of each kernel launch of a call and their
sum, and the us a call by CUDA events, beside the CUDA-event us of the
unfused composition's backward (chip_smoke.py's `library_ms` for #4), and a
digest of dx, dW1, db1, dW2 and db2 (inputs from a fixed seed: two trees
compare bit for bit); then the same summed over a step's six calls. It runs on an older tree
too, for a parent/change comparison in one run. It needs a CUDA device.

`mlp_fwd_calls` does the same for the fused GELU-MLP forward (#3,
`fused_mlp_fwd`) at the same two geometries, at rate 0.1 and 0: host us a
call, the host's own us a call, the device us a call (torch.profiler over
10 calls), the us a call by CUDA events, a digest of y (inputs from a fixed
seed: two trees compare bit for bit), whether two calls agree bit for bit,
and the unfused composition's forward by CUDA events beside it; then the
device and CUDA-event us summed over a step's six calls. It runs on an
older tree too, for a parent/change comparison in one run. It needs a CUDA
device.

`ln_calls` times the (residual +) LayerNorm (#6, `fused_layernorm`) at the
eight geometries of a served batch of Swinv2-base (batch 16), bf16 and
fp32: host us a call, the host's own us a call, the us a call by CUDA
events, and the device us a launch by torch.profiler (50 calls) twice:
warm, all calls on one input (at stages 2-3 it stays in the 50 MB L2), and
cold, the calls rotating over enough inputs to pass twice the L2, so each
call reads from device memory: the bound (bytes over 3.35 TB/s) is read
against the cold figure. Beside them, `F.layer_norm` plus the shortcut's
add on the same input (device us of both kernels, warm and cold); a digest of the output (inputs from a fixed
seed: two trees compare bit for bit) and whether two calls agree bit for
bit; at stage 2's residual geometry (72 of the 106 calls) also the host's
own us of each piece of the call path. Last, one line a dtype of the sums
over a served batch's 106 calls.
It runs on an older tree too (copy the new `profile_kernels.py` into it),
for a parent/change comparison in one run. It needs a CUDA device.

`topk_calls` times retrieval's scoring library calls at the three
Factify-2-sized corpora (text_train 35,000 x 768 and text_test 7,500 x 768
at k 25, image_corpus 41,256 x 2,048 at k 20) for Q 1 and 64 queries:
`ops/topk.py::topk_lower_index_first` alone on fp32 (Q, N) scores rounded
through bf16 (so ties occur), and the whole bf16 `dense_topk`, each as the
us a call by CUDA events and host us a call, beside `torch.topk` on the
same scores; a digest of the indices (inputs from a fixed seed: two trees
compare bit for bit). It runs on an older tree too (copy the new
`profile_kernels.py` into it), for a parent/change comparison in one run.
It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import re
import statistics
import subprocess
import tempfile
import time
from functools import partial
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
# (name, windows, C, heads): the Swinv2-base stages of a fine-tuning step,
# batch 8 (chip_smoke.py's FT_SWIN_GEOMS)
SWIN_GEOMETRIES = [("stage0", 64, 128, 4), ("stage1", 16, 256, 8),
                   ("stage2", 4, 512, 16), ("stage3", 1, 1024, 32)]
SWIN_BATCH = 8
# the serving kernel's calls in a served batch of 16 (chip_smoke.py's
# SWIN_GEOMS): (windows, C, heads, bias windows) -> calls
SWIN_SERVED = {(64, 128, 4, 1): 2, (64, 128, 4, 64): 2, (16, 256, 8, 1): 2,
               (16, 256, 8, 16): 2, (4, 512, 16, 1): 18, (4, 512, 16, 4): 18,
               (1, 1024, 32, 1): 4}
# the backward's calls a fine-tuning step at each stage: 2 images x the
# stage's blocks (chip_smoke.py's FT_SWIN_GEOMS)
SWIN_CALLS_A_STEP = {"stage0": 4, "stage1": 4, "stage2": 36, "stage3": 4}
# stages 0-2 of Swinv2-base at 16 x 16 and 24 x 24 windows, the blocked
# kernels (chip_smoke.py's SWIN_BLOCKED_GEOMS and FT_SWIN_BLOCKED_GEOMS):
# a served batch's calls by (windows, C, heads, bias windows), a
# fine-tuning step's stages as SWIN_GEOMETRIES
SWIN_TOKENS = (64, 256, 576)
SWIN_BLOCKED_SERVED = {(16, 128, 4, 1): 2, (16, 128, 4, 16): 2,
                       (4, 256, 8, 1): 2, (4, 256, 8, 4): 2,
                       (1, 512, 16, 1): 36}
SWIN_BLOCKED_GEOMETRIES = [("stage0", 16, 128, 4), ("stage1", 4, 256, 8),
                           ("stage2", 1, 512, 16)]
# the DeBERTa attention backward of a fine-tuning step (chip_smoke.py's
# FT_DEBERTA): B, T, D, heads
DEBERTA_BWD = (8, 256, 384, 6)
# the DeBERTa attention forwards of a served batch and of a fine-tuning
# step (chip_smoke.py's DEBERTA and FT_DEBERTA): name, B, T, D, heads
DEBERTA_FWD = [("served", 16, 512, 384, 6), ("finetune", 8, 256, 384, 6)]
_CALLS = 2000
# the fused MLP's calls in a bf16 train step (chip_smoke.py's MLP_GEOMS):
# (N, D, F) -> calls a step; the step's dropout rate
MLP_GEOMETRIES = {(131072, 256, 1024): 3, (16384, 256, 1024): 3}
MLP_RATE = 0.1
# Swinv2-base LayerNorms per served batch of 16 (chip_smoke.py's LN_GEOMS):
# (rows, C, shortcut) -> launches
LN_GEOMS = {(65536, 128, False): 2, (65536, 128, True): 8,
            (16384, 256, True): 8, (4096, 512, True): 72,
            (1024, 1024, True): 8, (16384, 256, False): 2,
            (4096, 512, False): 2, (1024, 1024, False): 4}
L2_BYTES = 50 * 2 ** 20
HBM_BYTES_PER_S = 3.35e12


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


def ptxas_remarks(log: str) -> list[str]:
    """The lines of an nvcc log that a kernel's author must read: warnings,
    and ptxas's C7514 (wgmma serialized), which it prints as an info
    line."""
    return [line.strip() for line in log.splitlines()
            if "warning" in line.lower() or "C7514" in line]


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
            for line in ptxas_remarks(log):
                print(json.dumps({"source": src, "warning": line}),
                      flush=True)


def _host_us(call, n: int = _CALLS) -> float:
    """Host microseconds a call over n calls ended by one device sync."""
    for _ in range(10):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


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
        host_us = _host_us(call)
        win = P.profile_window(call, 200, {"flash_fwd_kernel": "flash"})
        print(json.dumps({
            "geometry": name, "B": BATCH, "T": t, "S": s, "D": d, "H": h,
            "host_us_a_call": host_us,
            "kernel_device_us_a_launch": win["kernels_ms"]["flash"] * 1e3
            / 200, "card": P.card()}), flush=True)


def _swin_tables(SA) -> list:
    """(n, a served batch's calls, a step's stages) at each window size
    this tree's wrappers take (an older tree's: 64 tokens only)."""
    ok = getattr(SA, "_tokens_ok", lambda n: n == 64)
    return [(n, SWIN_SERVED, SWIN_GEOMETRIES) if n == 64 else
            (n, SWIN_BLOCKED_SERVED, SWIN_BLOCKED_GEOMETRIES)
            for n in SWIN_TOKENS if ok(n)]


def _groups(split, nw: int, b: int, h: int, n: int) -> int:
    """The wrapper's batch split; an older tree's takes no n (64 only)."""
    try:
        return split(nw, b, h, n)
    except TypeError:
        return split(nw, b, h)


def _swin_inputs(dev, gen, nw: int, c: int, h: int, n: int,
                 dtype=torch.bfloat16):
    """q', k, v and the log2-domain bias as the model makes them (see
    chip_smoke.py's phase_swin_train), in `dtype` (bias fp32); and SDPA's
    view of them."""
    b, dh, log2e = SWIN_BATCH, c // h, 1.4426950408889634

    def unit(x):
        x = x.reshape(nw, b, n, h, dh)
        return (x / x.norm(dim=-1, keepdim=True)).reshape(nw, b, n, c)

    q = unit(torch.randn(nw, b, n, c, device=dev, generator=gen)) \
        * (10 * log2e)
    k = unit(torch.randn(nw, b, n, c, device=dev, generator=gen))
    v = torch.randn(nw, b, n, c, device=dev, generator=gen)
    bias = 16 * torch.rand(nw, h, n, n, device=dev, generator=gen)
    if nw > 1:
        bias = bias - 200.0 * (torch.rand(nw, 1, n, n, device=dev,
                                          generator=gen) < 0.3)
    bias = (bias * log2e).contiguous()
    q, k, v = (x.to(dtype) for x in (q, k, v))
    q4, k4, v4 = (_sdpa_view(x, h) for x in (q, k, v))
    m4 = (math.log(2.0) * bias)[:, None].expand(nw, b, h, n, n).reshape(
        nw * b, h, n, n).to(dtype).contiguous()
    return (q, k, v, bias), (q4, k4, v4, m4)


def _sdpa_view(x, h: int):
    """(nW, B, n, C) -> SDPA's (nW B, h, n, dh)."""
    nw, b, n, c = x.shape
    return x.reshape(nw, b, n, h, c // h).transpose(2, 3).reshape(
        nw * b, h, n, c // h).contiguous()


def _swin_pieces(SA, q, k, v, bias, h: int) -> dict:
    """Host us a call of each piece of the forward wrapper's call path,
    timed alone; the last one, the C entry point with the call's
    arguments, launches the kernel (`c_entry` is the same call refused
    before the launch, and not part of the path). A piece this tree's
    wrapper does not have (an older tree's, for a comparison in one run)
    is None."""
    nw, b, n, c = q.shape

    def c_call(dtype=None):
        o, fn, dev = torch.empty_like(q), SA.load_train_kernel(), \
            q.get_device()
        args = (nw, b, n, h, c // h, _groups(SA.batch_groups, nw, b, h, n),
                SA._DTYPE_CODES[q.dtype] if dtype is None else dtype, dev,
                torch._C._cuda_getCurrentRawStream(dev))
        if len(fn.argtypes) != 5 + len(args):   # another tree's signature
            raise TypeError("the entry point takes other arguments")
        return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          bias.data_ptr(), o.data_ptr(), *args)

    dev = q.get_device()
    pieces = {
        "checks": lambda: partial(SA._check_train_inputs, q, k, v, bias, h),
        "empty_like": lambda: partial(torch.empty_like, q),
        "check_aligned": lambda: partial(cuda_build.check_aligned,
                                         q, k, v, bias, q),
        "get_device": lambda: q.get_device,
        "raw_stream": lambda: partial(torch._C._cuda_getCurrentRawStream,
                                      dev),
        "batch_groups": lambda: partial(_groups, SA.batch_groups, nw, b, h,
                                        n),
        # the entry point refusing dtype code -1 before any launch: ctypes
        # and the C function's own checks
        "c_entry": lambda: c_call(dtype=-1),
        "c_call": c_call}
    out = {}
    for name, make in pieces.items():
        try:
            call = make()
        except (AttributeError, TypeError):
            out[name] = None
        else:
            out[name] = _host_us(call)
    return out


def swin_calls() -> None:
    from mmd_tpu_torch.ops import swin_attention as SA
    if not torch.cuda.is_available():
        raise SystemExit("swin_calls needs a CUDA device")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    print(json.dumps({"card": P.card()}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, _, stages in _swin_tables(SA):
        step = {"device_us": 0.0, "device_us_fastest_split": 0.0}
        for name, nw, c, h in stages:
            (q, k, v, bias), (q4, k4, v4, m4) = _swin_inputs(dev, gen, nw, c,
                                                             h, n)
            call = lambda: SA.swin_window_attention_fwd(  # noqa: E731
                q, k, v, bias, h)
            lib = lambda: sdpa(q4, k4, v4, attn_mask=m4,  # noqa: E731
                               scale=math.log(2.0))
            host_us = _host_us(call)
            win = P.profile_window(call, 200, {"swin_train_fwd": "swin"})
            lib_host_us = _host_us(lib)
            lib_win = P.profile_window(lib, 200, {})
            piece_us = _swin_pieces(SA, q, k, v, bias, h)
            by_groups = {}
            for g in (d for d in range(1, SWIN_BATCH + 1)
                      if SWIN_BATCH % d == 0):
                entry = _swin_fwd_entry(SA, q, k, v, bias, h, g)
                if entry is None:
                    by_groups = None
                    break
                by_groups[g] = P.profile_window(
                    entry, 50, {"swin_train_fwd": "swin"})[
                    "kernels_ms"]["swin"] * 1e3 / 50
            out = call().float().cpu().numpy()
            device_us = win["kernels_ms"]["swin"] * 1e3 / 200
            step["device_us"] += SWIN_CALLS_A_STEP[name] * device_us
            if by_groups is not None:
                step["device_us_fastest_split"] += \
                    SWIN_CALLS_A_STEP[name] * min(by_groups.values())
            print(json.dumps({
                "geometry": name, "n": n, "nW": nw, "B": SWIN_BATCH,
                "C": c, "H": h,
                "groups": _groups(SA.batch_groups, nw, SWIN_BATCH, h, n),
                "o_sha256": hashlib.sha256(out.tobytes()).hexdigest()[:16],
                "host_us_a_call": host_us,
                "kernel_device_us_a_launch": device_us,
                "device_us_by_groups": by_groups,
                "sdpa_host_us_a_call": lib_host_us,
                "sdpa_device_us_a_call": lib_win["device_busy_ms"] * 1e3
                / 200,
                "piece_host_us": piece_us,
                "rest_host_us": host_us - sum(
                    x for k_, x in piece_us.items()
                    if x is not None and k_ != "c_entry"),
                "card": P.card()}), flush=True)
            del q, k, v, bias, q4, k4, v4, m4
            torch.cuda.empty_cache()
        print(json.dumps({"n": n, "per_step": sum(
            SWIN_CALLS_A_STEP[s[0]] for s in stages), "device_us_a_step": step,
            "card": P.card()}), flush=True)


def _swin_infer_inputs(dev, gen, nw: int, c: int, h: int, nwb: int,
                       n: int):
    """Raw q, k, v (fp32), the natural-log bias and the clamped logit scale
    as chip_smoke.py's phase_swin makes them, at batch 16."""
    q, k, v = (torch.randn(nw, BATCH, n, c, device=dev, generator=gen)
               for _ in range(3))
    bias = 16 * torch.rand(1, h, n, n, device=dev, generator=gen)
    if nwb > 1:
        bias = bias - 200.0 * (torch.rand(nwb, 1, n, n, device=dev,
                                          generator=gen) < 0.3)
    bias = bias.expand(nwb, h, n, n).contiguous()
    scale = torch.exp(torch.clamp(torch.rand(h, device=dev, generator=gen)
                                  * 5, max=math.log(100)))
    return q, k, v, bias, scale


def _swin_infer_entry(SA, q, k, v, bias, scale, h: int, groups: int):
    """#7's C entry point with the call's arguments at a given batch split;
    None where the tree's entry point takes no batch split."""
    nw, b, n, c = q.shape
    fn, dev = SA.load_kernel(), q.get_device()
    if len(fn.argtypes) != 16:
        return None
    o = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            scale.data_ptr(), o.data_ptr(), nw, b, n, h, c // h,
            bias.shape[0], groups, SA._DTYPE_CODES[q.dtype], dev,
            torch._C._cuda_getCurrentRawStream(dev))

    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"swin_window_attn: CUDA error {rc}")
    return call


def swin_infer_calls() -> None:
    from mmd_tpu_torch.ops import swin_attention as SA
    if not torch.cuda.is_available():
        raise SystemExit("swin_infer_calls needs a CUDA device")
    print(json.dumps({"card": P.card()}), flush=True)
    dev = torch.device("cuda")
    calls = 50
    for n, served, _ in _swin_tables(SA):
        batch = {}
        for dtype in (torch.bfloat16, torch.float32):
            name_dt = str(dtype).split(".")[-1]
            batch[name_dt] = {"device_us": 0.0, "event_us": 0.0,
                              "device_us_fastest_split": 0.0}
            gen = torch.Generator(device=dev).manual_seed(0)
            for (nw, c, h, nwb), count in served.items():
                q, k, v, bias, scale = _swin_infer_inputs(dev, gen, nw, c, h,
                                                          nwb, n)
                q, k, v = (x.to(dtype) for x in (q, k, v))
                call = lambda: SA.swin_window_attention_infer(  # noqa: E731
                    q, k, v, bias, scale, h)
                host_us = _host_us(call, 200)
                enqueue_us = _enqueue_us(call)
                event_us = _event_us(call)
                win = P.profile_window(call, calls, {"swin_attn": "swin"})
                device_us = win["kernels_ms"]["swin"] * 1e3 / calls
                by_groups = {}
                for g in (d for d in range(1, BATCH + 1) if BATCH % d == 0):
                    entry = _swin_infer_entry(SA, q, k, v, bias, scale, h, g)
                    if entry is None:
                        by_groups = None
                        break
                    by_groups[g] = P.profile_window(
                        entry, calls, {"swin_attn": "swin"})[
                        "kernels_ms"]["swin"] * 1e3 / calls
                out = call().float().cpu().numpy()
                batch[name_dt]["device_us"] += count * device_us
                batch[name_dt]["event_us"] += count * event_us
                if by_groups is not None:
                    batch[name_dt]["device_us_fastest_split"] += \
                        count * min(by_groups.values())
                print(json.dumps({
                    "n": n, "nW": nw, "B": BATCH, "C": c, "H": h,
                    "bias_windows": nwb, "dtype": name_dt,
                    "calls_a_batch": count,
                    "groups": (_groups(SA.batch_groups, nw, BATCH, h, n)
                               if by_groups is not None else None),
                    "o_sha256": hashlib.sha256(out.tobytes()).hexdigest()[:16],
                    "host_us_a_call": host_us,
                    "host_enqueue_us_a_call": enqueue_us,
                    "event_us_a_call": event_us,
                    "device_us_a_launch": device_us,
                    "device_us_by_groups": by_groups,
                    "card": P.card()}), flush=True)
                del q, k, v, bias
                torch.cuda.empty_cache()
        print(json.dumps({"n": n, "per_batch": sum(served.values()),
                          "us_a_batch": batch, "card": P.card()}), flush=True)


def _swin_bwd_entry(SA, q, k, v, bias, do, h: int, groups: int):
    """#9's C entry point with the call's arguments and a given batch split
    (the same signature on an older tree): one call, rc checked."""
    nw, b, n, c = q.shape
    fn, dev = SA.load_train_bwd_kernel(), q.get_device()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty_like(bias)
    # the workspace this tree's wrapper sizes (an older tree: the groups'
    # dbias parts)
    floats = (SA.bwd_workspace_floats(nw, b, h, n, groups)
              if hasattr(SA, "bwd_workspace_floats")
              else groups * bias.numel())
    ws = torch.empty(max(floats, 1), device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dbias.data_ptr(), ws.data_ptr(), nw, b, n, h, c // h, groups,
            SA._DTYPE_CODES[q.dtype], dev,
            torch._C._cuda_getCurrentRawStream(dev))

    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"swin_attn_train_bwd: CUDA error {rc}")
    return call


def swin_bwd_calls() -> None:
    from mmd_tpu_torch.ops import swin_attention as SA
    if not torch.cuda.is_available():
        raise SystemExit("swin_bwd_calls needs a CUDA device")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    print(json.dumps({"card": P.card()}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # an older tree splits the backward's batch as the forward's
    groups_of = getattr(SA, "bwd_batch_groups", SA.batch_groups)
    calls = 50
    for n, _, stages in _swin_tables(SA):
        step = {}
        for dtype in (torch.bfloat16, torch.float32):
            name_dt = str(dtype).split(".")[-1]
            step[name_dt] = {"device_us": 0.0, "device_us_fastest_split": 0.0}
            for name, nw, c, h in stages:
                (q, k, v, bias), (q4, k4, v4, m4) = _swin_inputs(
                    dev, gen, nw, c, h, n, dtype)
                do = torch.randn(q.shape, device=dev, generator=gen).to(dtype)
                call = lambda: SA.swin_window_attention_bwd(  # noqa: E731
                    q, k, v, bias, do, h)
                host_us = _host_us(call, 200)
                enqueue_us = _enqueue_us(call)
                event_us = _event_us(call)
                win = P.profile_window(call, calls, {})
                per_kernel = {k_: v_ * 1e3 / calls
                              for k_, v_ in win["device_ms_top"].items()
                              if "swin_train" in k_}
                by_groups = {}
                for g in (d for d in range(1, SWIN_BATCH + 1)
                          if SWIN_BATCH % d == 0):
                    w = P.profile_window(_swin_bwd_entry(
                        SA, q, k, v, bias, do, h, g), calls, {})
                    by_groups[g] = sum(v_ for k_, v_ in
                                       w["device_ms_top"].items()
                                       if "swin_train" in k_) * 1e3 / calls
                # SDPA's backward with the mask's gradient, as
                # chip_smoke.py's phase_swin_train takes its library time
                leaves = [x.detach().requires_grad_()
                          for x in (q4, k4, v4, m4)]
                try:
                    o4 = sdpa(*leaves[:3], attn_mask=leaves[3],
                              scale=math.log(2.0))
                    lib = lambda: torch.autograd.grad(  # noqa: E731
                        o4, leaves, _sdpa_view(do, h), retain_graph=True)
                    lib_event_us = _event_us(lib)
                    lib_device_us = P.profile_window(lib, calls, {})[
                        "device_busy_ms"] * 1e3 / calls
                except RuntimeError:             # no backend gives dmask
                    lib_event_us = lib_device_us = None
                device_us = sum(per_kernel.values())
                step[name_dt]["device_us"] += \
                    SWIN_CALLS_A_STEP[name] * device_us
                step[name_dt]["device_us_fastest_split"] += \
                    SWIN_CALLS_A_STEP[name] * min(by_groups.values())
                print(json.dumps({
                    "geometry": name, "n": n, "nW": nw, "B": SWIN_BATCH,
                    "C": c, "H": h, "dtype": name_dt,
                    "groups": _groups(groups_of, nw, SWIN_BATCH, h, n),
                    "host_us_a_call": host_us,
                    "host_enqueue_us_a_call": enqueue_us,
                    "event_us_a_call": event_us,
                    "device_us_a_call": device_us,
                    "device_us_by_kernel": per_kernel,
                    "device_us_by_groups": by_groups,
                    "sdpa_bwd_event_us_a_call": lib_event_us,
                    "sdpa_bwd_device_us_a_call": lib_device_us,
                    "card": P.card()}), flush=True)
                del leaves, q, k, v, do
                torch.cuda.empty_cache()
        print(json.dumps({"n": n, "per_step": sum(
            SWIN_CALLS_A_STEP[s_[0]] for s_ in stages),
            "device_us_a_step": step, "card": P.card()}), flush=True)


def _swin_fwd_entry(SA, q, k, v, bias, h: int, groups: int):
    """#8's C entry point with the call's arguments at a given batch split:
    one call, rc checked; None where the tree's entry point takes no batch
    split."""
    nw, b, n, c = q.shape
    fn, dev = SA.load_train_kernel(), q.get_device()
    if len(fn.argtypes) != 14:
        return None
    o = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), nw, b, n, h, c // h, groups,
            SA._DTYPE_CODES[q.dtype], dev,
            torch._C._cuda_getCurrentRawStream(dev))

    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"swin_attn_train_fwd: CUDA error {rc}")
    return call


def _enqueue_us(call, calls: int = 10, runs: int = 20) -> float:
    """The host's own us a call: `calls` calls enqueued on an idle card,
    timed before the sync (few enough that no launch waits for the queue);
    the median of `runs` such runs."""
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def _event_us(call, calls: int = 20) -> float:
    """us a call by CUDA events around `calls` back-to-back calls."""
    call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def deberta_fwd_calls() -> None:
    from mmd_tpu_torch.ops import deberta_attention as DA
    if not torch.cuda.is_available():
        raise SystemExit("deberta_fwd_calls needs a CUDA device")
    print(json.dumps({"card": P.card()}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    calls = 50
    for name, b, t, d, h in DEBERTA_FWD:
        x32 = [torch.randn(b, t, d, device=dev, generator=gen)
               for _ in range(3)]
        tabs32 = [torch.randn(2 * t, d, device=dev, generator=gen)
                  for _ in range(2)]
        # padded tails from 1 to T valid keys and a row with no valid key,
        # as chip_smoke.py's phase_deberta; the tokenizer's int mask
        lengths = torch.linspace(1, t, b - 1, device=dev).round().long()
        mask = torch.cat([torch.arange(t, device=dev)[None]
                          < lengths[:, None],
                          torch.zeros(1, t, dtype=torch.bool,
                                      device=dev)]).int()
        if hasattr(DA, "key_bytes"):
            mask = DA.key_bytes(mask)
        scale = 1.0 / math.sqrt(3.0 * d // h)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in x32)
            pk, pq = (x.to(dtype) for x in tabs32)
            call = lambda: DA.deberta_attention(  # noqa: E731
                q, k, v, pk, pq, mask, h, scale)
            host_us = _host_us(call, 200)
            enqueue_us = _enqueue_us(call)
            event_us = _event_us(call)
            win = P.profile_window(call, calls, {})
            per_kernel = {k_: v_ * 1e3 / calls
                          for k_, v_ in win["device_ms_top"].items()}
            print(json.dumps({
                "geometry": name, "B": b, "T": t, "D": d, "H": h,
                "dtype": str(dtype).split(".")[-1],
                "host_us_a_call": host_us,
                "host_enqueue_us_a_call": enqueue_us,
                "event_us_a_call": event_us,
                "device_us_a_call": sum(
                    v_ for k_, v_ in per_kernel.items()
                    if "deberta_attn" in k_),
                "device_us_by_kernel": per_kernel,
                "card": P.card()}), flush=True)


def deberta_bwd_calls() -> None:
    from mmd_tpu_torch.ops import deberta_attention as DA
    if not torch.cuda.is_available():
        raise SystemExit("deberta_bwd_calls needs a CUDA device")
    print(json.dumps({"card": P.card()}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    b, t, d, h = DEBERTA_BWD
    x32 = [torch.randn(b, t, d, device=dev, generator=gen) for _ in range(4)]
    tabs32 = [torch.randn(2 * t, d, device=dev, generator=gen)
              for _ in range(2)]
    # padded tails from 1 to T valid keys and a row with no valid key, as
    # chip_smoke.py's phase_deberta_bwd; the tokenizer's int mask
    lengths = torch.linspace(1, t, b - 1, device=dev).round().long()
    mask = torch.cat([torch.arange(t, device=dev)[None] < lengths[:, None],
                      torch.zeros(1, t, dtype=torch.bool, device=dev)]).int()
    scale = 1.0 / math.sqrt(3.0 * d // h)
    calls = 50
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (x.to(dtype) for x in x32)
        pk, pq = (x.to(dtype) for x in tabs32)
        call = lambda: DA.deberta_attention_bwd(  # noqa: E731
            q, k, v, pk, pq, mask, do, h, scale)
        host_us = _host_us(call, 200)
        enqueue_us = _enqueue_us(call)
        event_us = _event_us(call)
        win = P.profile_window(call, calls, {})
        per_kernel = {k_: v_ * 1e3 / calls
                      for k_, v_ in win["device_ms_top"].items()
                      if "deberta_bwd" in k_}
        print(json.dumps({
            "geometry": "finetune", "B": b, "T": t, "D": d, "H": h,
            "dtype": str(dtype).split(".")[-1],
            "host_us_a_call": host_us,
            "host_enqueue_us_a_call": enqueue_us,
            "checks_us_a_call": _host_us(partial(
                DA._check_kernel_inputs, q, k, v, pk, pq, mask, h)),
            "event_us_a_call": event_us,
            "device_us_a_call": sum(per_kernel.values()),
            "device_us_by_kernel": per_kernel,
            "card": P.card()}), flush=True)


def _mlp_inputs(dev, gen, n: int, d: int, f: int):
    x = torch.randn(n, d, device=dev, generator=gen).bfloat16()
    w1 = (torch.randn(d, f, device=dev, generator=gen)
          / math.sqrt(d)).bfloat16()
    b1 = 0.1 * torch.randn(f, device=dev, generator=gen)
    w2 = (torch.randn(f, d, device=dev, generator=gen)
          / math.sqrt(f)).bfloat16()
    b2 = 0.1 * torch.randn(d, device=dev, generator=gen)
    return x, w1, b1, w2, b2


def mlp_bwd_calls() -> None:
    from mmd_tpu_torch.ops import dropout as D
    from mmd_tpu_torch.ops import mlp as M
    if not torch.cuda.is_available():
        raise SystemExit("mlp_bwd_calls needs a CUDA device")
    fn = torch.nn.functional
    print(json.dumps({"card": P.card()}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rate, calls = MLP_RATE, 10
    step = {"device_us": 0.0, "event_us": 0.0, "composition_event_us": 0.0,
            "device_us_by_kernel": {}}
    for (n, d, f), count in MLP_GEOMETRIES.items():
        x, w1, b1, w2, b2 = _mlp_inputs(dev, gen, n, d, f)
        dy = torch.randn(n, d, device=dev, generator=gen).bfloat16()
        seeds = M.mask_seeds(rate, 1)
        call = lambda: M.fused_mlp_bwd(  # noqa: E731
            x, w1, b1, w2, dy, seeds, rate)
        digest = hashlib.sha256()
        for t in call():
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
        host_us = _host_us(call, 50)
        enqueue_us = _enqueue_us(call)
        event_us = _event_us(call)
        win = P.profile_window(call, calls, {})
        per_kernel = {k_: v_ * 1e3 / calls
                      for k_, v_ in win["device_ms_top"].items()
                      if "mlp" in k_}
        # the unfused bf16 composition's backward, as chip_smoke.py's
        # phase_mlp times it (its forward excluded)
        leaves = [t.detach().requires_grad_() for t in (
            x, w1.T.contiguous(), b1.bfloat16(), w2.T.contiguous(),
            b2.bfloat16())]
        hid = fn.gelu(fn.linear(leaves[0], leaves[1], leaves[2]),
                      approximate="tanh")
        hid = fn.linear(D.dropout(hid, rate, seeds[0]), leaves[3], leaves[4])
        out = D.dropout(hid, rate, seeds[1])
        comp_us = _event_us(lambda: torch.autograd.grad(
            out, leaves, dy, retain_graph=True), 5)
        del leaves, hid, out
        rec = {"geometry": f"N={n} D={d} F={f}", "rate": rate,
               "calls_a_step": count, "host_us_a_call": host_us,
               "host_enqueue_us_a_call": enqueue_us,
               "event_us_a_call": event_us,
               "device_us_a_call": sum(per_kernel.values()),
               "device_us_by_kernel": per_kernel,
               "composition_event_us_a_call": comp_us,
               "grads_sha256": digest.hexdigest()[:16], "card": P.card()}
        print(json.dumps(rec), flush=True)
        step["device_us"] += count * rec["device_us_a_call"]
        step["event_us"] += count * event_us
        step["composition_event_us"] += count * comp_us
        for k_, v_ in per_kernel.items():
            step["device_us_by_kernel"][k_] = \
                step["device_us_by_kernel"].get(k_, 0.0) + count * v_
        del x, w1, w2, dy
        torch.cuda.empty_cache()
    print(json.dumps({"per_step": sum(MLP_GEOMETRIES.values()), **step,
                      "card": P.card()}), flush=True)


def mlp_fwd_calls() -> None:
    from mmd_tpu_torch.ops import dropout as D
    from mmd_tpu_torch.ops import mlp as M
    if not torch.cuda.is_available():
        raise SystemExit("mlp_fwd_calls needs a CUDA device")
    fn = torch.nn.functional
    print(json.dumps({"card": P.card()}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    calls = 10
    step: dict = {}
    for (n, d, f), count in MLP_GEOMETRIES.items():
        x, w1, b1, w2, b2 = _mlp_inputs(dev, gen, n, d, f)
        for rate in (MLP_RATE, 0.0):
            seeds = M.mask_seeds(rate, 1)
            call = lambda: M.fused_mlp_fwd(  # noqa: E731
                x, w1, b1, w2, b2, seeds, rate)
            # the unfused bf16 composition's forward, as chip_smoke.py's
            # phase_mlp times it
            w1t, w2t, b1b, b2b = (w1.T.contiguous(), w2.T.contiguous(),
                                  b1.bfloat16(), b2.bfloat16())

            def composition():
                hid = fn.gelu(fn.linear(x, w1t, b1b), approximate="tanh")
                if rate:
                    hid = D.dropout(hid, rate, seeds[0])
                out = fn.linear(hid, w2t, b2b)
                return D.dropout(out, rate, seeds[1]) if rate else out

            comp_us = _event_us(composition, 5)
            y = call()
            torch.cuda.synchronize()
            digest = hashlib.sha256(
                y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
            again = torch.equal(y, call())
            win = P.profile_window(call, calls, {})
            device_us = sum(v * 1e3 / calls
                            for k, v in win["device_ms_top"].items()
                            if "mlp_fwd" in k)
            rec = {"geometry": f"N={n} D={d} F={f}", "rate": rate,
                   "calls_a_step": count,
                   "host_us_a_call": _host_us(call, 50),
                   "host_enqueue_us_a_call": _enqueue_us(call),
                   "event_us_a_call": _event_us(call),
                   "device_us_a_call": device_us,
                   "y_sha256": digest[:16], "twice_bit_identical": again,
                   "composition_event_us_a_call": comp_us,
                   "card": P.card()}
            print(json.dumps(rec), flush=True)
            acc = step.setdefault(rate, {"device_us": 0.0, "event_us": 0.0,
                                         "composition_event_us": 0.0})
            acc["device_us"] += count * device_us
            acc["event_us"] += count * rec["event_us_a_call"]
            acc["composition_event_us"] += count * comp_us
        del x, w1, w2
        torch.cuda.empty_cache()
    for rate, acc in step.items():
        print(json.dumps({"per_step": sum(MLP_GEOMETRIES.values()),
                          "rate": rate, **acc, "card": P.card()}),
              flush=True)


def _ln_device_us(calls_of, calls: int, symbol: str | None,
                  per_call: int = 1) -> float | None:
    """Device us a call of `calls_of(i)` (the i-th call) by torch.profiler
    over `calls` calls: the kernels whose symbol holds `symbol` (or every
    device event: None), `per_call` launches a call, averaged over the
    launches the trace holds (a window that lost every launch: None)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(calls):
            calls_of(i)
        torch.cuda.synchronize()
    us, launches = 0.0, 0
    for evt in prof.key_averages():
        t = P.device_us(evt)
        if t > 0 and (symbol is None or symbol in evt.key):
            us, launches = us + t, launches + evt.count
    return us / launches * per_call if launches else None


def _ln_pieces(LN, p, y, x) -> dict:
    """The host's own us a call (`_enqueue_us`) of each piece of the
    wrapper's call path: the whole call, the call without the routing rule
    and autograd (`_layernorm_cuda`), the C entry point alone with the
    call's arguments (it launches the kernel), the output's allocation and
    the routing rule."""
    out = torch.empty_like(y)
    fn = LN.load_kernel()
    dv = y.get_device()
    args = (y.data_ptr(), None if x is None else x.data_ptr(),
            p.weight.data_ptr(), p.bias.data_ptr(), out.data_ptr(),
            y.numel() // y.shape[-1], y.shape[-1], 1e-5,
            LN._DTYPE_CODES[y.dtype], dv,
            torch.cuda.current_stream(y.device).cuda_stream)
    return {"call": _enqueue_us(lambda: LN.fused_layernorm(p, y, 1e-5, x)),
            "wrapper": _enqueue_us(
                lambda: LN._layernorm_cuda(p.weight, p.bias, y, 1e-5, x)),
            "entry": _enqueue_us(lambda: fn(*args)),
            "empty_like": _enqueue_us(lambda: torch.empty_like(y)),
            "routing": _enqueue_us(lambda: LN.fused_ln_ok(y.shape))}


def ln_calls() -> None:
    from mmd_tpu_torch.ops import ln as LN
    if not torch.cuda.is_available():
        raise SystemExit("ln_calls needs a CUDA device")
    layer_norm = torch.nn.functional.layer_norm
    print(json.dumps({"card": P.card()}), flush=True)
    dev = torch.device("cuda")
    calls = 50
    keys = ("device_us_warm", "device_us_cold", "library_device_us_warm",
            "library_device_us_cold", "event_us", "host_us", "enqueue_us",
            "bound_us")
    batch = {}
    torch.set_grad_enabled(False)
    for dtype in (torch.bfloat16, torch.float32):
        name_dt = str(dtype).split(".")[-1]
        acc = batch[name_dt] = dict.fromkeys(keys, 0.0)
        gen = torch.Generator(device=dev).manual_seed(1)
        for (rows, c, res), count in LN_GEOMS.items():
            p = torch.nn.LayerNorm(c).to(dev)
            p.weight.normal_(generator=gen)
            p.bias.normal_(generator=gen)
            nbytes = rows * c * dtype.itemsize * (3 if res else 2)
            # input sets: the first is the warm one; all of them pass 2 L2s
            sets = [(torch.randn(rows, c, device=dev, generator=gen).to(dtype),
                     torch.randn(rows, c, device=dev, generator=gen).to(dtype)
                     if res else None)
                    for _ in range(1 + math.ceil(2 * L2_BYTES / nbytes))]
            y, x = sets[0]
            call = lambda: LN.fused_layernorm(p, y, 1e-5, x)  # noqa: E731

            def ours(i, s=None):
                yi, xi = sets[i % len(sets)] if s is None else sets[s]
                return LN.fused_layernorm(p, yi, 1e-5, xi)

            wb, bb = p.weight.to(dtype), p.bias.to(dtype)

            def library(i, s=None):
                yi, xi = sets[i % len(sets)] if s is None else sets[s]
                out = layer_norm(yi, (c,), wb, bb, 1e-5)
                return out if xi is None else out + xi

            out = call()
            torch.cuda.synchronize()
            rec = {"rows": rows, "C": c, "shortcut": res, "dtype": name_dt,
                   "calls_a_batch": count,
                   "out_sha256": hashlib.sha256(
                       out.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32).cpu().numpy().tobytes()
                   ).hexdigest()[:16],
                   "twice_bit_identical": torch.equal(out, call()),
                   "host_us": _host_us(call, 500),
                   "enqueue_us": _enqueue_us(call),
                   "event_us": _event_us(call),
                   "device_us_warm": _ln_device_us(partial(ours, s=0), calls,
                                                   "ln_kernel"),
                   "device_us_cold": _ln_device_us(ours, calls, "ln_kernel"),
                   "library_device_us_warm": _ln_device_us(
                       partial(library, s=0), calls, None, 1 + res),
                   "library_device_us_cold": _ln_device_us(
                       library, calls, None, 1 + res),
                   "bound_us": 1e6 * (nbytes + 8 * c) / HBM_BYTES_PER_S}
            if (rows, c, res) == (4096, 512, True):     # 72 of the 106
                rec["host_pieces_us"] = _ln_pieces(LN, p, y, x)
            for k in keys:
                acc[k] += count * rec[k]
            print(json.dumps({**rec, "card": P.card()}), flush=True)
            del sets, y, x, out
            torch.cuda.empty_cache()
    for name_dt, acc in batch.items():
        print(json.dumps({"per_batch": sum(LN_GEOMS.values()),
                          "dtype": name_dt, "us_a_batch": acc,
                          "card": P.card()}), flush=True)


TOPK_CORPORA = (("text_train", 35_000, 768, 25),
                ("text_test", 7_500, 768, 25),
                ("image_corpus", 41_256, 2_048, 20))


def topk_calls() -> None:
    from mmd_tpu_torch.ops import topk as T
    if not torch.cuda.is_available():
        raise SystemExit("topk_calls needs a CUDA device")
    print(json.dumps({"card": P.card()}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    for name, n, d, k in TOPK_CORPORA:
        corpus = T.l2_normalize(torch.randn(n, d, device=dev, generator=gen)
                                .to(torch.bfloat16))
        for q in (1, 64):
            query = T.l2_normalize(torch.randn(
                q, d, device=dev, generator=gen).to(torch.bfloat16))
            scores = (query.float() @ corpus.float().t()).to(
                torch.bfloat16).float()
            call = lambda: T.topk_lower_index_first(scores, k)  # noqa: E731
            whole = lambda: T.dense_topk(  # noqa: E731
                query, corpus, k, normalize=False)
            idx = torch.cat([call()[1], whole()[1]]).cpu().numpy()
            print(json.dumps({
                "corpus": name, "N": n, "D": d, "Q": q, "k": k,
                "topk_event_us_a_call": _event_us(call),
                "topk_host_us_a_call": _host_us(call, 200),
                "dense_topk_event_us_a_call": _event_us(whole),
                "dense_topk_host_us_a_call": _host_us(whole, 200),
                "torch_topk_event_us_a_call": _event_us(
                    lambda: torch.topk(scores, k)),
                "indices_sha256": hashlib.sha256(
                    idx.astype("int64").tobytes()).hexdigest()[:16],
                "card": P.card()}), flush=True)
        del corpus
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    sub.add_parser("ptxas").add_argument("sources", nargs="*")
    sub.add_parser("flash_calls")
    sub.add_parser("swin_calls")
    sub.add_parser("swin_infer_calls")
    sub.add_parser("swin_bwd_calls")
    sub.add_parser("deberta_fwd_calls")
    sub.add_parser("deberta_bwd_calls")
    sub.add_parser("mlp_bwd_calls")
    sub.add_parser("mlp_fwd_calls")
    sub.add_parser("ln_calls")
    sub.add_parser("topk_calls")
    args = ap.parse_args(argv)
    if args.what == "ptxas":
        ptxas(args.sources or sorted(f.name for f in cuda_build.CSRC.glob(
            "*.cu")))
    elif args.what == "flash_calls":
        flash_calls()
    elif args.what == "swin_calls":
        swin_calls()
    elif args.what == "swin_infer_calls":
        swin_infer_calls()
    elif args.what == "swin_bwd_calls":
        swin_bwd_calls()
    elif args.what == "deberta_fwd_calls":
        deberta_fwd_calls()
    elif args.what == "deberta_bwd_calls":
        deberta_bwd_calls()
    elif args.what == "mlp_fwd_calls":
        mlp_fwd_calls()
    elif args.what == "ln_calls":
        ln_calls()
    elif args.what == "topk_calls":
        topk_calls()
    else:
        mlp_bwd_calls()


if __name__ == "__main__":
    main()
