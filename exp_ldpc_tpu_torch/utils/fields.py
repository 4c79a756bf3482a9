"""Small finite fields GF(p^k) from scratch.

Replaces the `galois` field arithmetic the reference leans on for its
group-theoretic lifted products (``reference/python/qldpc/
lifted_product_code.py:18,47-104,164-212``).  Elements are represented as
integers in ``[0, p^k)`` whose base-p digits are the coefficients of the
polynomial representative (degree-ascending), i.e. the same integer
convention galois uses.  Multiplication/inversion go through log/antilog
tables built once per field, so everything is O(1) after construction; this
is plenty for the q <= 2^16 fields any of the constructions here touch.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List

import numpy as np

__all__ = ["FiniteField", "GF"]


def _factorize(n: int) -> List[int]:
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def _prime_power(q: int):
    fac = _factorize(q)
    p = fac[0]
    if any(f != p for f in fac):
        raise ValueError(f"{q} is not a prime power")
    return p, len(fac)


class FiniteField:
    """GF(p^k) with integer-coded elements and table-based arithmetic."""

    def __init__(self, q: int):
        self.order = q
        self.characteristic, self.degree = _prime_power(q)
        p, k = self.characteristic, self.degree
        if k == 1:
            self._mul_table = None
            # find a primitive root to expose a primitive element
            self.primitive_element = self._prime_primitive_root(p)
        else:
            self._irreducible = self._find_irreducible(p, k)
            self._build_tables()

    # ----- construction helpers -----
    @staticmethod
    def _prime_primitive_root(p: int) -> int:
        if p == 2:
            return 1
        fac = set(_factorize(p - 1))
        for g in range(2, p):
            if all(pow(g, (p - 1) // f, p) != 1 for f in fac):
                return g
        raise RuntimeError("no primitive root found")

    @staticmethod
    def _poly_mulmod(a: int, b: int, mod_poly: int, p: int, k: int) -> int:
        """Multiply field elements coded as base-p digit integers, reduce mod mod_poly."""
        # decode digits
        def digits(x, n):
            out = []
            for _ in range(n):
                out.append(x % p)
                x //= p
            return out

        da = digits(a, k)
        db = digits(b, k)
        prod = [0] * (2 * k - 1)
        for i, ai in enumerate(da):
            if ai:
                for j, bj in enumerate(db):
                    prod[i + j] = (prod[i + j] + ai * bj) % p
        dm = digits(mod_poly, k + 1)
        # reduce: mod poly is monic of degree k (leading digit may not be 1 -> normalize)
        lead = dm[k]
        inv_lead = pow(lead, p - 2, p)
        for i in range(2 * k - 2, k - 1, -1):
            c = prod[i]
            if c:
                f = (c * inv_lead) % p
                for j in range(k + 1):
                    prod[i - k + j] = (prod[i - k + j] - f * dm[j]) % p
        out = 0
        for i in range(k - 1, -1, -1):
            out = out * p + prod[i]
        return out

    @classmethod
    def _find_irreducible(cls, p: int, k: int) -> int:
        """Brute-force search for a monic irreducible polynomial of degree k over GF(p).

        Encoded as an integer with base-p digits (ascending), leading digit 1.
        Irreducibility tested by x^(p^k) == x and gcd-style distinctness
        x^(p^(k/r)) != x for prime divisors r of k (Rabin's test).
        """
        def powx(e: int, mod_poly: int) -> int:
            # compute x^e mod (mod_poly) via square&multiply in the quotient ring
            result = 1
            base = p  # the element 'x'
            while e:
                if e & 1:
                    result = cls._poly_mulmod(result, base, mod_poly, p, k)
                base = cls._poly_mulmod(base, base, mod_poly, p, k)
                e >>= 1
            return result

        prime_divs = set(_factorize(k))
        x_code = p
        for tail in range(p**k):
            cand = p**k + tail  # monic: leading digit 1
            if powx(p**k, cand) != x_code:
                continue
            if any(powx(p ** (k // r), cand) == x_code for r in prime_divs):
                continue
            return cand
        raise RuntimeError("no irreducible polynomial found")

    def _build_tables(self):
        p, k, q = self.characteristic, self.degree, self.order
        mul = lambda a, b: self._poly_mulmod(a, b, self._irreducible, p, k)
        # find generator of the multiplicative group
        fac = set(_factorize(q - 1))

        def elem_pow(a, e):
            r = 1
            while e:
                if e & 1:
                    r = mul(r, a)
                a = mul(a, a)
                e >>= 1
            return r

        gen = None
        for g in range(2, q):
            if all(elem_pow(g, (q - 1) // f) != 1 for f in fac):
                gen = g
                break
        assert gen is not None
        self.primitive_element = gen
        exp = np.zeros(2 * (q - 1), dtype=np.int64)
        log = np.zeros(q, dtype=np.int64)
        acc = 1
        for i in range(q - 1):
            exp[i] = acc
            exp[i + (q - 1)] = acc
            log[acc] = i
            acc = mul(acc, gen)
        self._exp, self._log = exp, log
        # addition in GF(p^k): digitwise mod-p add of base-p codes
        if p == 2:
            self._add = lambda a, b: np.bitwise_xor(a, b)
        else:
            digit_w = p ** np.arange(k, dtype=np.int64)

            def _add(a, b, digit_w=digit_w, p=p):
                a = np.asarray(a, dtype=np.int64)
                b = np.asarray(b, dtype=np.int64)
                da = (a[..., None] // digit_w) % p
                db = (b[..., None] // digit_w) % p
                return (((da + db) % p) * digit_w).sum(axis=-1)

            self._add = _add

    # ----- arithmetic (scalar or numpy array of int codes) -----
    @property
    def elements(self):
        return range(self.order)

    def add(self, a, b):
        if self.degree == 1:
            return (np.asarray(a, dtype=np.int64) + np.asarray(b, dtype=np.int64)) % self.characteristic
        return self._add(a, b)

    def neg(self, a):
        if self.degree == 1:
            return (-np.asarray(a, dtype=np.int64)) % self.characteristic
        if self.characteristic == 2:
            return np.asarray(a, dtype=np.int64)
        # negate each digit mod p
        p, k = self.characteristic, self.degree
        digit_w = p ** np.arange(k, dtype=np.int64)
        da = (np.asarray(a, dtype=np.int64)[..., None] // digit_w) % p
        return (((-da) % p) * digit_w).sum(axis=-1)

    def sub(self, a, b):
        return self.add(a, self.neg(b))

    def mul(self, a, b):
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        if self.degree == 1:
            return (a * b) % self.characteristic
        out = self._exp[self._log[a] + self._log[b]]
        return np.where((a == 0) | (b == 0), 0, out)

    def inv(self, a):
        a_arr = np.asarray(a, dtype=np.int64)
        if np.any(a_arr == 0):
            raise ZeroDivisionError("inverse of 0 in finite field")
        if self.degree == 1:
            p = self.characteristic
            return np.vectorize(lambda x: pow(int(x), p - 2, p))(a_arr)
        q = self.order
        return self._exp[(q - 1 - self._log[a_arr]) % (q - 1)]

    def pow(self, a, e: int):
        r = np.ones_like(np.asarray(a, dtype=np.int64))
        base = np.asarray(a, dtype=np.int64)
        e = int(e)
        while e:
            if e & 1:
                r = self.mul(r, base)
            base = self.mul(base, base)
            e >>= 1
        return r

    # ----- 2x2 matrix helpers (for GL2/PGL2) -----
    def mat2_mul(self, m1, m2):
        a = self.add(self.mul(m1[0][0], m2[0][0]), self.mul(m1[0][1], m2[1][0]))
        b = self.add(self.mul(m1[0][0], m2[0][1]), self.mul(m1[0][1], m2[1][1]))
        c = self.add(self.mul(m1[1][0], m2[0][0]), self.mul(m1[1][1], m2[1][0]))
        d = self.add(self.mul(m1[1][0], m2[0][1]), self.mul(m1[1][1], m2[1][1]))
        return ((int(a), int(b)), (int(c), int(d)))

    def mat2_det(self, m):
        return int(self.sub(self.mul(m[0][0], m[1][1]), self.mul(m[0][1], m[1][0])))

    def mat2_inv(self, m):
        det = self.mat2_det(m)
        di = int(self.inv(det))
        return (
            (int(self.mul(di, m[1][1])), int(self.mul(di, self.neg(m[0][1])))),
            (int(self.mul(di, self.neg(m[1][0]))), int(self.mul(di, m[0][0]))),
        )

    def subfield_elements(self, subfield_order: int):
        """Elements x of this field with x^q == x — the unique subfield GF(q)."""
        q = subfield_order
        els = [x for x in range(self.order) if int(self.pow(x, q)) == x]
        assert len(els) == q, f"expected {q} subfield elements, got {len(els)}"
        return els

    def __repr__(self):
        return f"FiniteField({self.order})"

    def __eq__(self, other):
        return isinstance(other, FiniteField) and other.order == self.order

    def __hash__(self):
        return hash(("FiniteField", self.order))


@lru_cache(maxsize=None)
def GF(q: int) -> FiniteField:
    """Cached field constructor."""
    return FiniteField(q)
