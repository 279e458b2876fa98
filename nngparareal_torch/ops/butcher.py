"""Butcher tableaus for the explicit Runge-Kutta families the port ships.

Port of ``nngparareal_tpu/ops/butcher.py``: RK1 (Euler), RK2 (midpoint),
RK4 (classic) and RK8 (Cooper-Verner, 11 stages). The coefficients are
Python-float tuples; the torch integrators unroll the stage loop over them.
The CUDA fan-out kernel compiles them in: ``cuda_header`` writes
``csrc/tableaus.cuh`` from these values, each as a C99 hexadecimal literal
(bitwise the Python double). Regenerate it after any change here with

    python -m nngparareal_torch.ops.butcher > nngparareal_torch/csrc/tableaus.cuh
"""

import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Tableau:
    name: str
    a: Tuple[Tuple[float, ...], ...]  # strictly lower-triangular stage matrix
    b: Tuple[float, ...]
    c: Tuple[float, ...]
    order: int

    @property
    def stages(self) -> int:
        return len(self.b)


def _euler() -> Tableau:
    return Tableau("RK1", ((0.0,),), (1.0,), (0.0,), order=1)


def _midpoint() -> Tableau:
    a = ((0.0, 0.0), (0.5, 0.0))
    return Tableau("RK2", a, (0.0, 1.0), (0.0, 0.5), order=2)


def _classic_rk4() -> Tableau:
    a = (
        (0.0, 0.0, 0.0, 0.0),
        (0.5, 0.0, 0.0, 0.0),
        (0.0, 0.5, 0.0, 0.0),
        (0.0, 0.0, 1.0, 0.0),
    )
    b = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
    c = (0.0, 0.5, 0.5, 1.0)
    return Tableau("RK4", a, b, c, order=4)


def _cooper_verner_rk8() -> Tableau:
    # Cooper-Verner 11-stage 8th-order method (same family the reference
    # uses, RK.py:42-46).
    s = math.sqrt(21.0)
    rows = [
        [],
        [1 / 2],
        [1 / 4, 1 / 4],
        [1 / 7, (-7 - 3 * s) / 98, (21 + 5 * s) / 49],
        [(11 + s) / 84, 0, (18 + 4 * s) / 63, (21 - s) / 252],
        [(5 + s) / 48, 0, (9 + s) / 36, (-231 + 14 * s) / 360, (63 - 7 * s) / 80],
        [
            (10 - s) / 42,
            0,
            (-432 + 92 * s) / 315,
            (633 - 145 * s) / 90,
            (-504 + 115 * s) / 70,
            (63 - 13 * s) / 35,
        ],
        [1 / 14, 0, 0, 0, (14 - 3 * s) / 126, (13 - 3 * s) / 63, 1 / 9],
        [
            1 / 32,
            0,
            0,
            0,
            (91 - 21 * s) / 576,
            11 / 72,
            (-385 - 75 * s) / 1152,
            (63 + 13 * s) / 128,
        ],
        [
            1 / 14,
            0,
            0,
            0,
            1 / 9,
            (-733 - 147 * s) / 2205,
            (515 + 111 * s) / 504,
            (-51 - 11 * s) / 56,
            (132 + 28 * s) / 245,
        ],
        [
            0,
            0,
            0,
            0,
            (-42 + 7 * s) / 18,
            (-18 + 28 * s) / 45,
            (-273 - 53 * s) / 72,
            (301 + 53 * s) / 72,
            (28 - 28 * s) / 45,
            (49 - 7 * s) / 18,
        ],
    ]
    n = 11
    a = tuple(tuple(row + [0.0] * (n - len(row))) for row in rows)
    b = (1 / 20, 0, 0, 0, 0, 0, 0, 49 / 180, 16 / 45, 49 / 180, 1 / 20)
    c = (
        0.0,
        1 / 2,
        1 / 2,
        (7 + s) / 14,
        (7 + s) / 14,
        1 / 2,
        (7 - s) / 14,
        (7 - s) / 14,
        1 / 2,
        (7 + s) / 14,
        1.0,
    )
    return Tableau("RK8", a, b, c, order=8)


TABLEAUS = {
    "RK1": _euler(),
    "RK2": _midpoint(),
    "RK4": _classic_rk4(),
    "RK8": _cooper_verner_rk8(),
}


def get_tableau(method) -> Tableau:
    if isinstance(method, Tableau):
        return method
    key = str(method).upper()
    if key not in TABLEAUS:
        raise NotImplementedError(
            f"Unknown RK method {method!r}; available: {sorted(TABLEAUS)}"
        )
    return TABLEAUS[key]


def dense_a(tab):
    """The stage matrix as an S x S tuple of floats."""
    s = tab.stages
    return tuple(tuple(float(row[j]) if j < len(row) else 0.0
                       for j in range(s)) for row in tab.a)


def cuda_header():
    """The text of csrc/tableaus.cuh: one struct per tableau of TABLEAUS,
    named as the tableau, with its index ``id`` (the C entry points'
    tableau argument), ``S``, ``a[S][S]`` and ``b[S]`` as hexadecimal
    literals, and the nonzero pattern ``nz_a``, ``nz_b``."""
    def row(vals, fmt):
        return "{" + ", ".join(fmt(v) for v in vals) + "}"

    hexf = lambda v: float(v).hex()
    flag = lambda v: "1" if v != 0.0 else "0"
    out = ["// The Butcher tableaus the fan-out kernels are compiled for.",
           "// Generated from nngparareal_torch/ops/butcher.py by",
           "//     python -m nngparareal_torch.ops.butcher "
           "> nngparareal_torch/csrc/tableaus.cuh",
           "// Each coefficient is float.hex() of butcher.py's value: "
           "bitwise the",
           "// Python double. Do not edit by hand.",
           "#pragma once", "", "namespace tableau {", ""]
    for idx, (name, tab) in enumerate(TABLEAUS.items()):
        a = dense_a(tab)
        out += [f"struct {name} {{",
                f"    static constexpr int id = {idx};",
                f"    static constexpr int S = {tab.stages};",
                "    static constexpr double a[S][S] = {"]
        out += [f"        {row(r, hexf)}," for r in a]
        out += ["    };",
                f"    static constexpr double b[S] = {row(tab.b, hexf)};",
                "    static constexpr int nz_a[S][S] = {"]
        out += [f"        {row(r, flag)}," for r in a]
        out += ["    };",
                f"    static constexpr int nz_b[S] = {row(tab.b, flag)};",
                "};", ""]
    out += ["}  // namespace tableau", ""]
    return "\n".join(out)


if __name__ == "__main__":
    print(cuda_header(), end="")
