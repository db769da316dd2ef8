"""Model-zoo resource fetching (counterpart of scail_tpu/utils/download.py;
reference: sat/resources/download.py + urls.py).

`auto_create(name)` resolves a zoo checkpoint directory, downloading and
unzipping it on first use under $SCAIL_HOME (falling back to $SAT_HOME
for reference compatibility, then ~/.scail_models), serialized across
processes by a file lock.  HTTP downloads resume from a partial file via
a Range header (download.py:20-40).  The reference's r2:// bucket path
needs boto3 and its embedded account keys; here r2:// names fail with a
clear error pointing at the HTTP mirror table instead.

No test reaches the network: the tests drive this module against a
localhost HTTP server that honours Range.
"""

from __future__ import annotations

import os
import zipfile
from typing import Optional

# public mirror table (sat/resources/urls.py) for the zoo families this
# framework implements; extend freely — auto_create also takes a raw url.
MODEL_URLS = {
    "bert-base-uncased": "https://cloud.tsinghua.edu.cn/d/dd80f9d39d454bc29ce4/files/?p=%2Fbert-base-uncased.zip&dl=1",
    "bert-large-uncased": "https://cloud.tsinghua.edu.cn/d/dd80f9d39d454bc29ce4/files/?p=%2Fbert-large-uncased.zip&dl=1",
    "roberta-base": "https://cloud.tsinghua.edu.cn/d/dd80f9d39d454bc29ce4/files/?p=%2Froberta-base.zip&dl=1",
    "roberta-large": "https://cloud.tsinghua.edu.cn/d/dd80f9d39d454bc29ce4/files/?p=%2Froberta-large.zip&dl=1",
    "vit-base-patch16-224-in21k": "https://cloud.tsinghua.edu.cn/d/dd80f9d39d454bc29ce4/files/?p=%2Fvit-base-patch16-224-in21k.zip&dl=1",
    "cait-s24-224": "https://cloud.tsinghua.edu.cn/d/dd80f9d39d454bc29ce4/files/?p=%2Fcait-s24-224.zip&dl=1",
    "gpt2": "https://cloud.tsinghua.edu.cn/d/dd80f9d39d454bc29ce4/files/?p=%2Fgpt2.zip&dl=1",
    "eva02_L_pt_m38m_p14": "https://cloud.tsinghua.edu.cn/d/dd80f9d39d454bc29ce4/files/?p=%2Feva02_L_pt_m38m_p14.zip&dl=1",
    "llama-7b": "https://cloud.tsinghua.edu.cn/d/dd80f9d39d454bc29ce4/files/?p=%2Fllama-7b.zip&dl=1",
    "clip": "https://cloud.tsinghua.edu.cn/d/dd80f9d39d454bc29ce4/files/?p=%2Fclip.zip&dl=1",
    "clip-vit-base-patch16": "https://lfs.aminer.cn/misc/clip/clip-vit-base-patch16.zip",
    "clip-vit-large-patch14": "https://lfs.aminer.cn/misc/clip/clip-vit-large-patch14.zip",
}


def download_with_progress_bar(save_path: str, url: str,
                               chunk_size: int = 1 << 16,
                               show_progress: bool = True) -> None:
    """Resumable streaming HTTP download (download.py:20-40): an existing
    partial file continues from its size via a Range request; a server
    that ignores Range (HTTP 200 instead of 206) restarts from zero."""
    import requests

    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    done = os.path.getsize(save_path) if os.path.exists(save_path) else 0
    headers = {"Range": f"bytes={done}-"} if done else None

    with requests.get(url, stream=True, headers=headers, timeout=60) as r:
        if done and r.status_code == 200:
            done = 0  # no Range support: the body is the whole file
        elif done and r.status_code == 416:
            return  # already complete: the range is unsatisfiable
        r.raise_for_status()
        total = int(r.headers.get("content-length", 0)) + done
        if total and total == done:
            return
        pbar = None
        if show_progress:
            try:
                from tqdm import tqdm

                pbar = tqdm(total=total, unit="B", unit_scale=True,
                            desc=save_path, initial=done)
            except ImportError:
                pass
        mode = "ab" if done else "wb"
        with open(save_path, mode) as f:
            for chunk in r.iter_content(chunk_size=chunk_size):
                if chunk:
                    f.write(chunk)
                    if pbar:
                        pbar.update(len(chunk))
        if pbar:
            pbar.close()


def _home(path: Optional[str]) -> str:
    if path is None:
        path = (os.getenv("SCAIL_HOME") or os.getenv("SAT_HOME")
                or "~/.scail_models")
    return os.path.expanduser(path)


def _lock(path: str):
    try:
        from filelock import FileLock

        return FileLock(path, mode=0o777)
    except ImportError:  # pragma: no cover - filelock is baked in
        import contextlib

        return contextlib.nullcontext()


def auto_create(name: str, *, path: Optional[str] = None,
                url: Optional[str] = None,
                show_progress: bool = True) -> str:
    """Resolve (downloading + unzipping if needed) the directory of a
    named zoo checkpoint (download.py:42-81).  url='local' skips any
    fetch; url=None consults MODEL_URLS."""
    path = _home(path)
    model_path = os.path.join(path, name)
    if url == "local":
        return model_path
    os.makedirs(os.path.dirname(model_path), exist_ok=True)
    with _lock(model_path + ".lock"):
        if url is None:
            if name not in MODEL_URLS:
                raise KeyError(
                    f"unknown model {name!r}: pass url=... or add it to "
                    f"scail_tpu_torch.utils.download.MODEL_URLS")
            url = MODEL_URLS[name]
        if url.startswith("r2://"):
            if not os.path.isdir(model_path):
                raise RuntimeError(
                    f"{name} lives in the reference's private r2 bucket "
                    f"({url}); fetch it out of band into {model_path} or "
                    f"pass an HTTP url=.")
        elif not os.path.isdir(model_path):
            file_path = os.path.join(path, name + ".zip")
            download_with_progress_bar(file_path, url,
                                       show_progress=show_progress)
        if not os.path.isdir(model_path):
            file_path = os.path.join(path, name + ".zip")
            with zipfile.ZipFile(file_path, "r") as f:
                f.extractall(path=path)
            assert os.path.isdir(model_path), (
                f"unzip failed, or the zip's first-level folder is not "
                f"{name}")
    return model_path
