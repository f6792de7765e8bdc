"""4-bit IUPAC basepair codec, vectorized over numpy arrays.

Semantics mirror the reference's QuickVariants `Basepairs` class (used throughout
mapper; see e.g. HashBlock_BaseRow.java:33-43,
AlignmentParameters.java:155-180, and the fixture BasepairsTest.java:9-51 which pins
the partial-ambiguity penalty at AmbiguityPenalty * (popcount(union)-1)/3).

Encoding: one bit per concrete base so that set operations are bitwise:
    A=1, C=2, G=4, T=8; IUPAC ambiguity codes are unions of those bits; N=15.
- can_match(a, b)  == (a & b) != 0
- union(a, b)      == a | b
- complement       swaps A<->T and C<->G (bit reversal of the nibble)
- is_ambiguous     == popcount != 1
- mutation_false_negative_rate(code) == (popcount(code) - 1) / 3
  (the probability that a mutation at this position would be invisible given the
   ambiguity; 0 for a concrete base, 1 for N)

All tables are numpy arrays so entire sequences encode/decode in one shot; the
same nibble codes are what the device kernels consume.
"""

from __future__ import annotations

import numpy as np

A, C, G, T = 1, 2, 4, 8
N = 15
GAP = 0  # never a valid base; used as padding

_IUPAC = {
    "A": A,
    "C": C,
    "G": G,
    "T": T,
    "U": T,
    "M": A | C,
    "R": A | G,
    "W": A | T,
    "S": C | G,
    "Y": C | T,
    "K": G | T,
    "V": A | C | G,
    "H": A | C | T,
    "D": A | G | T,
    "B": C | G | T,
    "N": N,
    "X": N,
    "-": GAP,
}

# char byte -> 4-bit code (uppercase and lowercase); unknown chars map to N
ENCODE_TABLE = np.full(256, N, dtype=np.uint8)
for _ch, _code in _IUPAC.items():
    ENCODE_TABLE[ord(_ch)] = _code
    ENCODE_TABLE[ord(_ch.lower())] = _code

# 4-bit code -> char byte
DECODE_TABLE = np.full(16, ord("N"), dtype=np.uint8)
for _ch, _code in _IUPAC.items():
    if _ch in "ACGTMRWSYKVHDBN-":
        DECODE_TABLE[_code] = ord(_ch)

# complement of a 4-bit code: reverse the nibble's bits (A<->T, C<->G)
COMPLEMENT_TABLE = np.zeros(16, dtype=np.uint8)
for _code in range(16):
    comp = 0
    if _code & A:
        comp |= T
    if _code & C:
        comp |= G
    if _code & G:
        comp |= C
    if _code & T:
        comp |= A
    COMPLEMENT_TABLE[_code] = comp

POPCOUNT_TABLE = np.array([bin(i).count("1") for i in range(16)], dtype=np.uint8)

# false-negative rate for a mutation hidden by ambiguity (BasepairsTest.java:35-44)
FALSE_NEGATIVE_RATE_TABLE = np.array(
    [max(0, int(POPCOUNT_TABLE[i]) - 1) / 3.0 for i in range(16)], dtype=np.float64
)

# 4-bit code -> 2-bit code for the concrete bases (A=0, C=1, G=2, T=3), matching the
# base-case hash values of HashBlock.java:171-188; ambiguity codes map to -1.
TWO_BIT_TABLE = np.full(16, -1, dtype=np.int8)
TWO_BIT_TABLE[A] = 0
TWO_BIT_TABLE[C] = 1
TWO_BIT_TABLE[G] = 2
TWO_BIT_TABLE[T] = 3

# charToInt used by the gapmer extension hash (HashBlock.java:152-169):
# A->1, C->2, G->3, T->4, anything else (incl. ambiguity codes) -> 0
GAPMER_CHAR_VALUE_TABLE = np.zeros(16, dtype=np.int64)
GAPMER_CHAR_VALUE_TABLE[A] = 1
GAPMER_CHAR_VALUE_TABLE[C] = 2
GAPMER_CHAR_VALUE_TABLE[G] = 3
GAPMER_CHAR_VALUE_TABLE[T] = 4


def encode(text: str | bytes) -> np.ndarray:
    """Encode a string of IUPAC characters to an array of 4-bit codes."""
    if isinstance(text, str):
        text = text.encode("ascii")
    raw = np.frombuffer(text, dtype=np.uint8)
    return ENCODE_TABLE[raw]


def decode(codes: np.ndarray) -> str:
    """Decode an array of 4-bit codes back to an IUPAC string."""
    return DECODE_TABLE[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def decode_one(code: int) -> str:
    return chr(DECODE_TABLE[code])


def complement(codes: np.ndarray) -> np.ndarray:
    return COMPLEMENT_TABLE[np.asarray(codes, dtype=np.uint8)]


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    return COMPLEMENT_TABLE[np.asarray(codes, dtype=np.uint8)][::-1]


def can_match(a, b) -> np.ndarray:
    """Whether the two (arrays of) codes could represent the same base."""
    return (np.asarray(a, dtype=np.uint8) & np.asarray(b, dtype=np.uint8)) != 0


def union(a, b):
    return np.asarray(a, dtype=np.uint8) | np.asarray(b, dtype=np.uint8)


def is_ambiguous(codes) -> np.ndarray:
    return POPCOUNT_TABLE[np.asarray(codes, dtype=np.uint8)] != 1


def is_fully_ambiguous(codes) -> np.ndarray:
    return np.asarray(codes, dtype=np.uint8) == N


def mutation_false_negative_rate(codes) -> np.ndarray:
    return FALSE_NEGATIVE_RATE_TABLE[np.asarray(codes, dtype=np.uint8)]


def possibilities(code: int) -> list[int]:
    """The concrete bases covered by an ambiguity code, in A,C,G,T order
    (matches the expansion order of HashBlock_BaseRow.java:34-42)."""
    return [b for b in (A, C, G, T) if code & b]
