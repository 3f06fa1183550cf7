"""Tokenizers of the port (NLLB on the shared SentencePiece model)."""
