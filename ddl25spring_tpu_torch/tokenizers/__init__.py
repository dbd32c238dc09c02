from .spm import ByteTokenizer, SentencePieceTokenizer, load_tokenizer  # noqa: F401
