"""Host-side helpers of the serving entry points: the tokenizer loader and
the in-repo SentencePiece runtime."""
