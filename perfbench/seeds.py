"""One run seed, several independent streams."""

import hashlib


def derive(seed: int, what: str) -> int:
    """A 63-bit seed for the stream ``what`` of the run seed ``seed``
    (any whole number)."""
    digest = hashlib.sha256(('%d/%s' % (int(seed), what)).encode()).digest()
    return int.from_bytes(digest[:8], 'little') >> 1
