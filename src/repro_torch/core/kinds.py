"""The Omega/Psi kind registry (the port's own copy; imports nothing).

Dense kinds draw every entry of Omega i.i.d. from Philox counter grids
(``core/rng.py``).  Sparse kinds place ONE nonzero per row:

  countsketch — Clarkson-Woodruff: Omega[g, h(g)] = s(g) with h uniform
                over the r columns and s a random sign, both drawn from
                the row's Philox counter.
  rowsample   — coordinated sampling: row g participates iff its uniform
                draw u_g < p = min(1, r/n); a kept row scatters
                s(g)/sqrt(p) into column h(g), so E[Omega·Omega^T] = I.
"""

DENSE_KINDS = ("normal", "uniform", "rademacher")
SPARSE_KINDS = ("countsketch", "rowsample")
VALID_KINDS = DENSE_KINDS + SPARSE_KINDS


def validate_kind(kind: str) -> None:
    """Eager kind check shared by every public entry point."""
    if kind not in VALID_KINDS:
        raise ValueError(f"unknown omega kind {kind!r}; valid kinds: "
                         f"{', '.join(VALID_KINDS)}")
