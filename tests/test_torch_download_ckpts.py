"""The port's tools/download_ckpts.py against the JAX package's, offline.

The counterparts of tests/test_download_ckpts.py: every download goes
through an injected opener, so no test opens a network connection. Both
packages name the same URLs and files; all four models download, an
existing file is kept, a failed attempt is retried, a dead network gives a
clear error with no partial file left, and the CLI refuses an unknown model.
"""

import io
import os
import urllib.error

import pytest

from det_sam2_tpu.tools import download_ckpts as jax_dl

from det_sam2_tpu_torch.tools import download_ckpts as dl
from det_sam2_tpu_torch.tools.download_ckpts import (
    BASE_URL,
    CHECKPOINTS,
    download_checkpoints,
    download_one,
    main,
)


class _Resp(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _quiet(s):
    pass


def test_same_urls_and_files_as_jax():
    assert BASE_URL == jax_dl.BASE_URL
    assert {k: v[0] for k, v in CHECKPOINTS.items()} == {
        k: v[0] for k, v in jax_dl.CHECKPOINTS.items()}
    # each names the preset its weights load into, as JAX's names its config
    assert {k: v[1] for k, v in CHECKPOINTS.items()} == {
        k: v[1] for k, v in jax_dl.CHECKPOINTS.items()}


@pytest.mark.parametrize("pkg", [dl, jax_dl], ids=["port", "jax"])
def test_download_all_models(tmp_path, pkg):
    seen = []

    def opener(url, timeout):
        seen.append((url, timeout))
        return _Resp(url.encode())

    paths = pkg.download_checkpoints(str(tmp_path), opener=opener, log=_quiet)
    assert set(paths) == set(CHECKPOINTS)
    for name, (fname, _) in CHECKPOINTS.items():
        p = os.path.join(str(tmp_path), fname)
        assert paths[name] == p
        with open(p, "rb") as f:
            assert f.read() == f"{BASE_URL}/{fname}".encode()
    assert [u for u, _ in seen] == [f"{BASE_URL}/{f}" for f, _ in CHECKPOINTS.values()]
    assert all(t == 30.0 for _, t in seen)  # every request has a connect timeout
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".part")]


def test_skip_existing_and_retry(tmp_path):
    fname, _ = CHECKPOINTS["tiny"]
    dest = tmp_path / fname
    dest.write_bytes(b"already here")
    calls, logged = [], []

    def opener(url, timeout):
        calls.append(url)
        return _Resp(b"fresh")

    paths = download_checkpoints(str(tmp_path), models=("tiny",), opener=opener,
                                 log=logged.append)
    assert calls == [] and paths == {"tiny": str(dest)}
    assert dest.read_bytes() == b"already here"
    assert logged[0] == f"{fname} already present, skipping"

    # retry: the first attempt fails, the second succeeds
    attempts = []

    def flaky(url, timeout):
        attempts.append(url)
        if len(attempts) == 1:
            raise urllib.error.URLError("reset")
        return _Resp(b"ok")

    out = str(tmp_path / "retry.bin")
    assert download_one("http://x/y", out, opener=flaky, retries=1) == out
    assert len(attempts) == 2
    with open(out, "rb") as f:
        assert f.read() == b"ok"


@pytest.mark.parametrize("error", [urllib.error.URLError("no route to host"),
                                   TimeoutError("timed out")], ids=["urlerror", "timeout"])
def test_failure_raises_clear_error(tmp_path, error):
    attempts = []

    def dead(url, timeout):
        attempts.append(url)
        raise error

    with pytest.raises(RuntimeError, match="no network egress"):
        download_one("http://x/y", str(tmp_path / "z"), opener=dead, retries=0)
    assert len(attempts) == 1
    assert not os.path.exists(tmp_path / "z.part")
    assert not os.path.exists(tmp_path / "z")


def test_unknown_model_rejected(tmp_path, capsys):
    with pytest.raises(ValueError, match="unknown model"):
        download_checkpoints(str(tmp_path), models=("nope",), log=_quiet)
    # the CLI: argparse refuses it with rc 2, as JAX's
    for cli in (main, jax_dl.main):
        with pytest.raises(SystemExit) as e:
            cli(["--models", "nope", "--out-dir", str(tmp_path)])
        assert e.value.code == 2
    capsys.readouterr()


def test_cli_returns_1_on_a_dead_network(tmp_path, monkeypatch, capsys):
    def dead(url, timeout):
        raise urllib.error.URLError("no route to host")

    monkeypatch.setattr(dl.urllib.request, "urlopen", dead)
    monkeypatch.setattr(dl.time, "sleep", lambda s: None)
    assert main(["--models", "small", "--out-dir", str(tmp_path)]) == 1
    assert "no network egress" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []
    # and 0 when the file is already there
    (tmp_path / CHECKPOINTS["small"][0]).write_bytes(b"x")
    assert main(["--models", "small", "--out-dir", str(tmp_path)]) == 0


def test_no_convert_flag(capsys):
    """JAX's --convert writes a flax .npz; the port's build reads the .pt."""
    with pytest.raises(SystemExit) as e:
        main(["--convert"])
    assert e.value.code == 2
