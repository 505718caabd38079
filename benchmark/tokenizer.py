"""A deterministic stand-in for the flan-t5 tokenizer (no vocabulary is in
the repository): each word hashed to an id below 32000, then the
end-of-text id 1, padded with 0 to ``max_length``.  It has the Hugging
Face call contract the port's ``T5TextEncoder`` takes; the program and the
reference both read its ids."""

import hashlib

import numpy as np


def hash_tokenizer(texts, truncation=True, max_length=77,
                   padding='max_length', return_tensors='np'):
    ids = np.zeros((len(texts), max_length), np.int64)
    for i, text in enumerate(texts):
        words = [2 + int.from_bytes(hashlib.blake2s(
            w.encode(), digest_size=4).digest(), 'little') % 31998
            for w in text.lower().split()]
        words = (words + [1])[:max_length]
        ids[i, :len(words)] = words
    return {'input_ids': ids}
