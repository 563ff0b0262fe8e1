"""Evaluation: sample-quality parity statistics (counterpart of
facegen/eval/__init__.py).

Lazy re-exports (PEP 562), so that ``python -m facegen_torch.eval.parity``
does not import the submodule twice.
"""

_EXPORTS = (
    "d_penultimate_features",
    "frechet_distance",
    "ks_2samp",
    "min_nn_distances",
    "parity_report",
    "sample_report",
    "self_report",
    "spearman",
)


def __getattr__(name):
    if name in _EXPORTS:
        from facegen_torch.eval import parity

        return getattr(parity, name)
    raise AttributeError(name)


__all__ = list(_EXPORTS)
