"""Download the official SAM 2.1 checkpoints.

Counterpart of the JAX package's ``tools/download_ckpts.py`` (after the
reference's ``checkpoints/download_ckpts.sh``, a wget loop over the four
SAM 2.1 ``.pt`` files): the same URLs and file names, an existing file kept,
each request with a connect timeout and one retry, and a clear error instead
of a hang where there is no network.

The JAX package's ``--convert`` (each ``.pt`` also written as a flax
``.npz``) has no counterpart: the port's ``build`` reads the ``.pt`` as it
is (``build_sam2_video_predictor("hiera_s", "checkpoints/sam2.1_hiera_small.pt")``).

    python -m det_sam2_tpu_torch.tools.download_ckpts [--out-dir checkpoints] [--models small ...]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional

BASE_URL = "https://dl.fbaipublicfiles.com/segment_anything_2/092824"

# name -> (file name, the preset of configs.MODEL_CONFIGS it loads into)
CHECKPOINTS: Dict[str, tuple] = {
    "tiny": ("sam2.1_hiera_tiny.pt", "hiera_t"),
    "small": ("sam2.1_hiera_small.pt", "hiera_s"),
    "base_plus": ("sam2.1_hiera_base_plus.pt", "hiera_b+"),
    "large": ("sam2.1_hiera_large.pt", "hiera_l"),
}

_CHUNK = 1 << 20  # 1 MiB


def download_one(
    url: str,
    dest: str,
    opener: Optional[Callable] = None,
    timeout: float = 30.0,
    retries: int = 1,
) -> str:
    """Stream ``url`` to ``dest`` (through ``dest.part``, renamed when
    complete). ``opener(url, timeout=...)`` returns a file-like response
    (default ``urllib.request.urlopen``)."""
    opener = opener or urllib.request.urlopen
    tmp = dest + ".part"
    last_err: Optional[Exception] = None
    for attempt in range(retries + 1):
        try:
            with opener(url, timeout=timeout) as resp, open(tmp, "wb") as f:
                shutil.copyfileobj(resp, f, _CHUNK)
            os.replace(tmp, dest)
            return dest
        except (urllib.error.URLError, OSError) as e:  # timeouts included
            last_err = e
            if os.path.exists(tmp):
                os.remove(tmp)
            if attempt < retries:
                time.sleep(1.0)
    raise RuntimeError(
        f"failed to download {url}: {last_err} "
        "(no network egress? fetch the file elsewhere and pass its path as "
        "the checkpoint to the builders directly)"
    )


def download_checkpoints(
    out_dir: str,
    models=("tiny", "small", "base_plus", "large"),
    opener: Optional[Callable] = None,
    log: Callable[[str], None] = print,
) -> Dict[str, str]:
    """Download the requested SAM 2.1 checkpoints into ``out_dir``; a file
    already there is kept. Returns {model name: local path}."""
    os.makedirs(out_dir, exist_ok=True)
    paths: Dict[str, str] = {}
    for name in models:
        if name not in CHECKPOINTS:
            raise ValueError(
                f"unknown model {name!r}; choose from {sorted(CHECKPOINTS)}"
            )
        fname = CHECKPOINTS[name][0]
        dest = os.path.join(out_dir, fname)
        if os.path.exists(dest):
            log(f"{fname} already present, skipping")
        else:
            log(f"downloading {fname} ...")
            download_one(f"{BASE_URL}/{fname}", dest, opener=opener)
        paths[name] = dest
    log("All checkpoints are downloaded successfully.")
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out-dir", default="checkpoints")
    p.add_argument(
        "--models",
        nargs="+",
        default=list(CHECKPOINTS),
        choices=sorted(CHECKPOINTS),
    )
    args = p.parse_args(argv)
    try:
        download_checkpoints(args.out_dir, models=args.models)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
