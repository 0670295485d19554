"""Plain reference of the paper's NTT-128 unit: the cyclic forward
transform of 128-point rows over one prime, out in bit-reversed order
(slot s holds X[bitrev(s)], X[k] = sum_j x[j] omega^(j k) mod q), with
omega = psi^2 and psi = g^((q-1)/2n) for g the smallest primitive root
of q (the rule frozen in ``modring.root``).  torch and numpy only."""
from __future__ import annotations

import torch

from reference.modring import EXACT, Arith, bitrev, powers, root


class CyclicNtt:
    def __init__(self, q: int, n: int, device="cpu", arith: Arith = EXACT):
        self.q, self.n, self.arith = q, n, arith
        self.device = torch.device(device)
        omega = pow(root(q, 2 * n), 2, q)
        t = lambda rows: torch.tensor(rows, dtype=torch.int64, device=self.device)
        self.tables = []
        m = 1
        while m < n:
            self.tables.append(t(powers(pow(omega, n // (2 * m), q), m, q)))
            m *= 2
        self.br = torch.tensor(bitrev(n), device=self.device)

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        """rows (B, n) residues -> (B, n) transforms in bit-reversed order."""
        q, n = self.q, self.n
        x = rows.long().to(self.device)[:, self.br]
        m = 1
        for w in self.tables:
            x = x.reshape(-1, n // (2 * m), 2 * m)
            u, v = x[..., :m], self.arith.mul(x[..., m:], w, torch.tensor(q, device=self.device))
            x = torch.cat(((u + v) % q, (u - v) % q), dim=-1)
            m *= 2
        return x.reshape(-1, n)[:, self.br]


def brute_force(row, q: int, n: int) -> list[int]:
    """O(n^2) Python-integer transform of one row, bit-reversed order."""
    omega = pow(root(q, 2 * n), 2, q)
    X = [sum(int(x) * pow(omega, j * k, q) for j, x in enumerate(row)) % q
         for k in range(n)]
    return [X[i] for i in bitrev(n)]
