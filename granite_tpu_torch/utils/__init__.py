"""Host utilities (copies of granite_tpu/utils)."""

from .hashing import Hasher, fnv1a, hash_combine
