"""Pure-Python AES-128 block cipher (copy of tidb_tpu/expr/_aes.py) — fallback for AES_ENCRYPT/DECRYPT
when the optional `cryptography` package is absent (MySQL's default
aes-128-ecb mode only needs the raw block transform; padding and key
folding live in builtins_ext2). Verified against the FIPS-197 appendix C
vector at import time, so a transcription slip can never silently
corrupt user data."""

from __future__ import annotations

_SBOX = bytes.fromhex(
    "637c777bf26b6fc53001672bfed7ab76ca82c97dfa5947f0add4a2af9ca472c0"
    "b7fd9326363ff7cc34a5e5f171d8311504c723c31896059a071280e2eb27b275"
    "09832c1a1b6e5aa0523bd6b329e32f8453d100ed20fcb15b6acbbe394a4c58cf"
    "d0efaafb434d338545f9027f503c9fa851a3408f929d38f5bcb6da2110fff3d2"
    "cd0c13ec5f974417c4a77e3d645d197360814fdc222a908846eeb814de5e0bdb"
    "e0323a0a4906245cc2d3ac629195e479e7c8376d8dd54ea96c56f4ea657aae08"
    "ba78252e1ca6b4c6e8dd741f4bbd8b8a703eb5664803f60e613557b986c11d9e"
    "e1f8981169d98e949b1e87e9ce5528df8ca1890dbfe6426841992d0fb054bb16"
)
_INV_SBOX = bytearray(256)
for _i, _v in enumerate(_SBOX):
    _INV_SBOX[_v] = _i
_INV_SBOX = bytes(_INV_SBOX)

_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x1B) & 0xFF if a & 0x100 else a


def _mul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a = _xtime(a)
        b >>= 1
    return out


def expand_key(key: bytes) -> list[bytes]:
    """128-bit key schedule → 11 round keys of 16 bytes."""
    words = [key[i : i + 4] for i in range(0, 16, 4)]
    for r in range(10):
        w = words[-1]
        w = bytes(
            (_SBOX[w[1]] ^ _RCON[r], _SBOX[w[2]], _SBOX[w[3]], _SBOX[w[0]])
        )
        for j in range(4):
            w = bytes(x ^ y for x, y in zip(words[-4], w))
            words.append(w)
            if j < 3:
                w = words[-1]
    return [b"".join(words[i : i + 4]) for i in range(0, 44, 4)]


def _add_round_key(s: bytearray, rk: bytes) -> None:
    for i in range(16):
        s[i] ^= rk[i]


_SHIFT = [0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11]
_INV_SHIFT = [0, 13, 10, 7, 4, 1, 14, 11, 8, 5, 2, 15, 12, 9, 6, 3]


def encrypt_block(block: bytes, round_keys: list[bytes]) -> bytes:
    s = bytearray(block)
    _add_round_key(s, round_keys[0])
    for rnd in range(1, 11):
        s = bytearray(_SBOX[s[_SHIFT[i]]] for i in range(16))  # sub+shift
        if rnd < 10:
            t = bytearray(16)
            for c in range(0, 16, 4):
                a0, a1, a2, a3 = s[c : c + 4]
                t[c] = _xtime(a0) ^ _xtime(a1) ^ a1 ^ a2 ^ a3
                t[c + 1] = a0 ^ _xtime(a1) ^ _xtime(a2) ^ a2 ^ a3
                t[c + 2] = a0 ^ a1 ^ _xtime(a2) ^ _xtime(a3) ^ a3
                t[c + 3] = _xtime(a0) ^ a0 ^ a1 ^ a2 ^ _xtime(a3)
            s = t
        _add_round_key(s, round_keys[rnd])
    return bytes(s)


def decrypt_block(block: bytes, round_keys: list[bytes]) -> bytes:
    s = bytearray(block)
    _add_round_key(s, round_keys[10])
    for rnd in range(9, -1, -1):
        s = bytearray(_INV_SBOX[s[_INV_SHIFT[i]]] for i in range(16))
        _add_round_key(s, round_keys[rnd])
        if rnd > 0:
            t = bytearray(16)
            for c in range(0, 16, 4):
                a0, a1, a2, a3 = s[c : c + 4]
                t[c] = _mul(a0, 14) ^ _mul(a1, 11) ^ _mul(a2, 13) ^ _mul(a3, 9)
                t[c + 1] = _mul(a0, 9) ^ _mul(a1, 14) ^ _mul(a2, 11) ^ _mul(a3, 13)
                t[c + 2] = _mul(a0, 13) ^ _mul(a1, 9) ^ _mul(a2, 14) ^ _mul(a3, 11)
                t[c + 3] = _mul(a0, 11) ^ _mul(a1, 13) ^ _mul(a2, 9) ^ _mul(a3, 14)
            s = t
    return bytes(s)


def ecb_encrypt(data: bytes, key: bytes) -> bytes:
    rks = expand_key(key)
    return b"".join(
        encrypt_block(data[i : i + 16], rks) for i in range(0, len(data), 16)
    )


def ecb_decrypt(data: bytes, key: bytes) -> bytes:
    rks = expand_key(key)
    return b"".join(
        decrypt_block(data[i : i + 16], rks) for i in range(0, len(data), 16)
    )


# FIPS-197 appendix C.1 known-answer self-check
_K = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
_P = bytes.fromhex("00112233445566778899aabbccddeeff")
_C = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
assert ecb_encrypt(_P, _K) == _C and ecb_decrypt(_C, _K) == _P, (
    "AES self-check failed"
)
del _K, _P, _C
