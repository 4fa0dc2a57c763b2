"""Calibration and evaluation data, offline only.

Own copy of ``microscopiq_tpu/eval/data.py`` (numpy only): seeded random
``seqlen`` crops of a corpus's train split and its test split as one token
stream, as the reference's ``get_loaders`` gives them. A dataset resolves,
in order, to an HF-datasets directory ``$MICROSCOPIQ_DATA_DIR/<name>``
(``datasets`` imported only then), a text file
``$MICROSCOPIQ_DATA_DIR/<name>.txt``, or, for the name ``synthetic`` and
behind ``allow_synthetic`` / ``MICROSCOPIQ_ALLOW_SYNTHETIC``, the built-in
synthetic corpus. ``MICROSCOPIQ_DATA_DIR`` defaults to ``data/`` at the
root of the checkout. Crops and token ids are bit-identical to the JAX
package's for the same seed.
"""

from __future__ import annotations

import os
import warnings
import zlib
from pathlib import Path
from typing import List, Tuple

import numpy as np

_WORDS = (
    "the of and to in a is that for it as was with be by on not he this are "
    "or his from at which but have an had they you were their one all we can "
    "her has there been if more when will would who so no out up into do "
    "time two like only some could them see other than then now look over "
    "its new take state years quantization tensor block scale exponent "
    "outlier weight matrix model language compute memory cache token "
    "attention layer hidden gradient hessian inverse cholesky pipeline "
    "hardware accelerator systolic butterfly network precision mantissa"
).split()


def data_dir() -> str:
    """``$MICROSCOPIQ_DATA_DIR``, else ``data/`` at the checkout's root."""
    return os.environ.get("MICROSCOPIQ_DATA_DIR",
                          str(Path(__file__).resolve().parents[2] / "data"))


def synthetic_corpus(n_tokens_approx: int = 600_000, seed: int = 1234) -> str:
    """Deterministic zipf-ish text corpus for offline pipeline runs."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, len(_WORDS) + 1)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    words = rng.choice(np.asarray(_WORDS), size=n_tokens_approx, p=probs)
    out, line = [], []
    for w in words:
        line.append(w)
        if len(line) >= int(rng.integers(8, 25)):
            out.append(" ".join(line) + ".")
            line = []
    return "\n".join(out)


def _load_text(name: str, allow_synthetic: bool = False) -> str:
    root = data_dir()
    path_dir = os.path.join(root, name)
    path_txt = os.path.join(root, f"{name}.txt")
    if os.path.isdir(path_dir):
        try:
            import datasets
            ds = datasets.load_from_disk(path_dir)
            col = "text" if "text" in ds.column_names else ds.column_names[0]
            return "\n\n".join(ds[col])
        except Exception:
            pass
    if os.path.isfile(path_txt):
        with open(path_txt) as f:
            return f.read()
    if name != "synthetic":
        # a reportable run never prints a synthetic perplexity as if it
        # were the real corpus's
        if not (allow_synthetic
                or os.environ.get("MICROSCOPIQ_ALLOW_SYNTHETIC")):
            raise FileNotFoundError(
                f"dataset '{name}' not found under {root}. Place the corpus "
                f"at {path_dir}/ (HF datasets.save_to_disk) or {path_txt}, "
                "or pass --allow-synthetic / set MICROSCOPIQ_ALLOW_SYNTHETIC=1"
                " to fall back to the synthetic corpus (perplexities NOT "
                "comparable)")
        warnings.warn(
            f"dataset '{name}' not found under {root}; falling back to the "
            "synthetic corpus (perplexities are NOT comparable)")
    return synthetic_corpus()


def _hash_tokenize(text: str, vocab_size: int = 256) -> np.ndarray:
    """Word-hash tokenizer for synthetic pipelines: crc32, not the salted
    builtin ``hash()``, so that ids do not change from run to run."""
    toks = [zlib.crc32(w.encode()) % (vocab_size - 2) + 2
            for w in text.split()]
    return np.asarray(toks, np.int32)


def get_loaders(name: str, nsamples: int = 128, seed: int = 0,
                seqlen: int = 2048, tokenizer=None,
                allow_synthetic: bool = False
                ) -> Tuple[List[np.ndarray], np.ndarray]:
    """(train crops, each (1, seqlen), and the test token stream).

    tokenizer: anything with ``encode() -> list[int]``; None uses the word
    hash tokenizer (synthetic pipelines only).
    """
    text = _load_text(name, allow_synthetic)
    split = int(len(text) * 0.9)
    train_text, test_text = text[:split], text[split:]
    if tokenizer is None:
        tokenize = _hash_tokenize
    else:
        tokenize = lambda s: np.asarray(tokenizer.encode(s), np.int32)  # noqa: E731
    train_ids = tokenize(train_text)
    test_ids = tokenize(test_text)

    rng = np.random.default_rng(seed)
    crops = []
    for _ in range(nsamples):
        if len(train_ids) <= seqlen + 1:
            start = 0
        else:
            start = int(rng.integers(0, len(train_ids) - seqlen - 1))
        crops.append(train_ids[start:start + seqlen][None, :])
    return crops, test_ids
