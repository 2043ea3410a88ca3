"""Tokenizer loading for the port's CLIs and server (the port's copy of
``autosmoothquant_tpu/utils/tokenizer.py``): HF ``AutoTokenizer`` where
``transformers`` is installed and loads the directory, else the in-repo
SentencePiece runtime (``utils/sp_tokenizer.py``) on the directory's
``tokenizer.model``. A machine without ``transformers`` (or
``tokenizers``) still serves text through the second."""

from __future__ import annotations

import os


def load_tokenizer(path: str, trust_remote_code: bool = True):
    """The tokenizer of the checkpoint or tokenizer directory ``path``;
    RuntimeError naming ``path`` when neither loader can read it."""
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(path, trust_remote_code=trust_remote_code)
    except Exception as e:  # ImportError included: no transformers here
        model_file = os.path.join(path, "tokenizer.model")
        if os.path.exists(model_file):
            from .sp_tokenizer import BaichuanTokenizer

            return BaichuanTokenizer(model_file)
        raise RuntimeError(
            f"no loadable tokenizer at {path} (AutoTokenizer failed and no "
            f"tokenizer.model present): {e}") from e
