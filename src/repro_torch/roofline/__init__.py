"""Roofline terms of the port's dry run (``launch/dryrun.py``)."""

from repro_torch.roofline.analysis import (
    HBM_BW,
    ICI_BW,
    PEAK_FLOPS,
    CollectiveStats,
    RooflineTerms,
    extract,
    format_row,
    HEADER,
    model_flops,
    parse_collectives,
    shape_bytes,
)

__all__ = ["extract", "RooflineTerms", "CollectiveStats",
           "parse_collectives", "shape_bytes", "model_flops",
           "format_row", "HEADER", "PEAK_FLOPS", "HBM_BW", "ICI_BW"]
