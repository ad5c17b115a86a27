"""Does the port give the same bits on every thread of one CUDA card?

    python3 thread_scan.py                  # the SDPA table, then every mode
    python3 thread_scan.py encoder MODE     # one mode in this process

The server runs each request on a thread of its own, so a session served
over HTTP equals the same session run in process only if every op rounds
alike on every thread. PyTorch keeps its cuBLAS, cuBLASLt and cuDNN handles
a thread.

SDPA table: F.scaled_dot_product_attention at Hiera-S's windowed-attention
shapes (bf16), with torch's own pick of backend and with each backend
forced: run once on this thread, again on it, then on THREADS new threads,
each compared bit for bit with the first run.

Encoder modes (one process each, since the settings are process-wide):
hiera-S's image encoder (seeded random weights, one seeded 1024^2 frame) on
this thread, again on it, on THREADS new threads one after another, and on
two threads alive at once (one after the other under a lock, as the
server's inference lock runs them). For each thread, the first of the
encoder's leaf modules whose output differs (with whether its input was
equal: an unequal input means a non-module op before it) and the features'
max abs difference.

  engine      the engine as built (it turns torch's cuDNN attention off)
  cudnn_sdp   cuDNN attention turned back on after the engine is built
  cudnn_ws    as cudnn_sdp, with CUBLAS_WORKSPACE_CONFIG=:4096:8

Prints the card's name and power limit first; exits non-zero, having run
nothing, without a card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from pathlib import Path

THREADS = 6
MODES = ("engine", "cudnn_sdp", "cudnn_ws")
SDPA_SHAPES = ((1024, 1, 64, 96), (256, 2, 64, 192))  # Hiera-S stages 1-2 windows


def _on_threads(fn, n):
    """fn() on n new threads, one after another: their results."""
    out = []
    for _ in range(n):
        box = {}
        t = threading.Thread(target=lambda: box.update(r=fn()))
        t.start()
        t.join()
        out.append(box["r"])
    return out


def sdpa_table():
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    for shape in SDPA_SHAPES:
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        row = [f"torch's pick {SDPBackend(torch._fused_sdp_choice(q, k, v)).name}"]
        for name, be in (("pick", None), ("cudnn", SDPBackend.CUDNN_ATTENTION),
                         ("flash", SDPBackend.FLASH_ATTENTION),
                         ("efficient", SDPBackend.EFFICIENT_ATTENTION),
                         ("math", SDPBackend.MATH)):
            def run():
                if be is None:
                    return F.scaled_dot_product_attention(q, k, v)
                with sdpa_kernel([be]):
                    return F.scaled_dot_product_attention(q, k, v)
            ref = run()
            again = torch.equal(ref, run())
            same = sum(torch.equal(ref, y) for y in _on_threads(run, THREADS))
            row.append(f"{name}: again equal {again}, {same} of {THREADS} threads equal")
        print(f"[sdpa] q{list(shape)} bf16: " + "; ".join(row), flush=True)


def encoder(mode):
    import numpy as np
    import torch

    from det_sam2_tpu_torch.configs import sam2_1_hiera_s
    from det_sam2_tpu_torch.ops import attention as att
    from det_sam2_tpu_torch.track import SAM2Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    att.build_kernels()
    dev = torch.device("cuda", 0)
    eng = SAM2Engine(sam2_1_hiera_s(), dtype=torch.bfloat16, device=dev, seed=0)
    if mode != "engine":
        torch.backends.cuda.enable_cudnn_sdp(True)
    frame = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (1, 1024, 1024, 3), dtype=np.uint8)).to(dev)
    rec = {}

    def hook(name):
        def h(mod, inp, out):
            r = rec.get(threading.get_ident())
            if r is not None and torch.is_tensor(out):
                r.append((name, inp[0].clone() if inp and torch.is_tensor(inp[0]) else None,
                          out.clone()))
        return h
    for name, m in eng.model.image_encoder.named_modules():
        if not list(m.children()):
            m.register_forward_hook(hook(name))

    def run():
        rec[threading.get_ident()] = []
        feats = eng.encode_image(frame)
        torch.cuda.synchronize()
        return rec.pop(threading.get_ident()), feats

    def compare(ref, got):
        first = next((f"{n} (input equal {ia is None or torch.equal(ia, ib)})"
                      for (n, ia, oa), (_, ib, ob) in zip(ref[0], got[0])
                      if not torch.equal(oa, ob)), None)
        diff = [float((a.float() - b.float()).abs().max()) for a, b in zip(ref[1], got[1])]
        return first, diff

    ref = run()
    again = compare(ref, run())
    threads = [compare(ref, r) for r in _on_threads(run, THREADS)]
    lock, bar, boxes = threading.Lock(), threading.Barrier(2), [{}, {}]

    def both(i):
        bar.wait()
        with lock:
            boxes[i]["r"] = run()
        bar.wait()
    ts = [threading.Thread(target=both, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    conc = [compare(ref, b["r"]) for b in boxes]
    differ = [t for t in threads if t[0] is not None]
    print(f"[encoder {mode}] cuDNN attention {torch.backends.cuda.cudnn_sdp_enabled()}, "
          f"CUBLAS_WORKSPACE_CONFIG {os.environ.get('CUBLAS_WORKSPACE_CONFIG')}: this thread "
          f"again differs {again[0] is not None}; {len(differ)} of {THREADS} new threads "
          f"differ, first at {sorted({t[0] for t in differ})}, features (s0, s1, top) max "
          f"abs diff {[t[1] for t in differ][:1]}; two threads at once: "
          f"{sum(c[0] is not None for c in conc)} of 2 differ", flush=True)


def main() -> int:
    if sys.argv[1:] == ["encoder", "cudnn_ws"]:  # before torch's first cuBLAS call
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    if not torch.cuda.is_available():
        print("thread_scan: no CUDA device; nothing was run")
        return 2
    if sys.argv[1:2] == ["encoder"]:
        encoder(sys.argv[2])
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    sdpa_table()
    rc = 0
    for mode in MODES:
        rc |= subprocess.run([sys.executable, str(Path(__file__).resolve()), "encoder",
                              mode]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
