"""Prime utilities for cache set counts.

The set count of each per-table cache is the first prime >= the requested
cache size, so that ``index % sets`` spreads correlated index streams across
sets. The reference implements this with a buggy primality test
(``isPrime`` misses perfect squares and all even numbers,
model_no_ddp.py:319-331, and ``find_next_prime``
model_no_ddp.py:122-125 can therefore return composites).
We implement the intended semantics correctly (see SURVEY.md §7 quirk list).
"""

from __future__ import annotations


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    i = 3
    while i * i <= n:
        if n % i == 0:
            return False
        i += 2
    return True


def next_prime(n: int) -> int:
    """Smallest prime >= n (n >= 1)."""
    c = max(2, int(n))
    while not is_prime(c):
        c += 1
    return c
