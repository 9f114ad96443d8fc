"""The result shape of a finished checker.

The counterpart of ``checker_summary`` in
``stateright_tpu/serve/portfolio.py``; ``diversify`` and the portfolio race
are not ported yet.
"""

from __future__ import annotations


def checker_summary(checker) -> dict:
    """The common result shape of one finished checker: counts, per-property
    verdicts, encoded discoveries, and the first counterexample-classified
    discovery in the model's property order (the run's ``violation``).  The
    verdicts are ``core/checker.py::property_verdicts``, which the
    incremental store's records use too."""
    from ..core.checker import property_verdicts

    model = checker.model()
    discoveries = checker.discoveries()
    props, violation = property_verdicts(checker)
    return {
        "state_count": checker.state_count(),
        "unique_state_count": checker.unique_state_count(),
        "max_depth": checker.max_depth(),
        "properties": props,
        "discoveries": {
            name: {
                "classification": checker.discovery_classification(name),
                "fingerprints": path.encode(model),
                "actions": repr(path.into_actions()),
            }
            for name, path in discoveries.items()
        },
        "violation": violation,
    }
