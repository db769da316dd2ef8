"""HuggingFace-datasets wrapper (counterpart of scail_tpu/data/hf_dataset.py;
reference: sat/data_utils/hf_dataset.py:1-40).

Same contract: an `hf://name/sub/split` path string, a per-sample
process_fn applied through datasets.map with a persistent on-disk cache
keyed by (dataset, sub, split, transformer_name), and a column-restricted
numpy view (the loader collates numpy; the trainer moves batches to the
device).  `offline=True` keeps the hub out of reach, so a processed cache
loads with no network.  `datasets` is imported at call time.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple


def parse_huggingface_path(path: str) -> Tuple[str, Optional[str], str]:
    """'hf://ds/sub/split' -> (ds, sub or None, split); '*' sub means
    default config (hf_dataset.py:12-19)."""
    if path.startswith("hf://"):
        path = path[5:]
    names = path.split("/")
    first = names[0]
    second = names[1] if len(names) >= 2 and names[1] != "*" else None
    split = names[2] if len(names) >= 3 else "train"
    return first, second, split


def load_hf_dataset(path: str, process_fn: Optional[Callable] = None, *,
                    columns: Optional[Sequence[str]] = None,
                    cache_dir: str = "~/.cache/huggingface/datasets",
                    offline: bool = False,
                    transformer_name: Optional[str] = None,
                    rebuild: bool = False):
    """Load + preprocess an HF dataset with a processed-cache
    (hf_dataset.py:21-40).  Returns a datasets.Dataset in numpy format."""
    if offline:
        # before `import datasets`, which reads these into module constants;
        # the constants too, for a caller that imported it already
        os.environ["HF_DATASETS_OFFLINE"] = "1"
        os.environ["HF_HUB_OFFLINE"] = "1"
    import datasets

    if offline:
        import huggingface_hub.constants

        huggingface_hub.constants.HF_HUB_OFFLINE = True
        datasets.config.HF_HUB_OFFLINE = datasets.config.HF_DATASETS_OFFLINE = True

    name, sub, split = parse_huggingface_path(path)
    cache_dir = os.path.expanduser(cache_dir)
    if transformer_name:
        processed_path = os.path.join(
            cache_dir, f"{name.replace('/', '_')}_{sub}_{split}_"
            f"{transformer_name}.data")
    else:
        processed_path = None

    if processed_path and os.path.exists(processed_path) and not rebuild:
        ds = datasets.load_from_disk(processed_path)
    else:
        ds = datasets.load_dataset(
            name, sub, cache_dir=cache_dir, split=split,
            download_config=datasets.DownloadConfig(max_retries=20))
        if process_fn is not None:
            ds = ds.map(process_fn, batched=False, load_from_cache_file=True)
        if processed_path:
            ds.save_to_disk(processed_path)
    ds.set_format(type="numpy", columns=list(columns) if columns else None)
    return ds
