"""The servable grid-walk workload: the monotone walk on ``[0, bound]**2``
(``models/fixtures.GridWalk``) as a registered workload, the gang wave's
family (``fleet/gang.py``): walks of different bounds share one launch a
wave.  ``(bound + 1)**2`` unique states, the corner at depth ``2 * bound +
1`` (a depth counts states); the ALWAYS property never fails, so every
completed check is exhaustive."""

from __future__ import annotations

from .fixtures import GridWalk


def cli_spec():
    from ..cli import CliSpec

    return CliSpec(
        name="grid walk",
        build=lambda n: GridWalk(bound=n),
        default_n=8,
        n_meta="BOUND",
        gpu=True,
        gpu_kwargs=dict(capacity=1 << 12, max_frontier=1 << 7),
    )
