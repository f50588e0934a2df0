"""Area / power model of the NTT-PIM compute unit (paper Table II).

The paper synthesizes the CU (fully-pipelined Montgomery BU + registers +
crossbar) at Samsung 65 nm and estimates atom-buffer SRAM with CACTI 7.0.
Without the foundry PDK we reproduce the *model structure*:

    area(Nb) = A_cu + A_buf_port * (Nb - 1)

(the primary buffer is the pre-existing GSA, hence Nb - 1 added SRAM
buffers; each added buffer also adds crossbar ports, folded into the
per-buffer coefficient).  The coefficients are calibrated once against
the paper's own four Table II points, and the calibration residual is
reported by the benchmark — i.e. we verify the paper's claimed scaling
is consistent with its own architecture description, and extrapolate
beyond Nb = 6.
"""
from __future__ import annotations

import numpy as np

#: Table II (mm^2, Samsung 65 nm logic + CACTI 7.0 buffers)
BANK_AREA_MM2 = 4.2208
NEWTON_AREA_MM2 = 0.0474
PAPER_TABLE2 = {1: 0.0213, 2: 0.0232, 4: 0.0263, 6: 0.0285}


def fit_area_model() -> tuple[float, float, float]:
    """Least-squares (A_cu, A_buf_port) + max |residual| vs Table II."""
    nbs = np.array(sorted(PAPER_TABLE2), float)
    areas = np.array([PAPER_TABLE2[int(n)] for n in nbs])
    X = np.stack([np.ones_like(nbs), nbs - 1], axis=1)
    coef, *_ = np.linalg.lstsq(X, areas, rcond=None)
    resid = np.abs(X @ coef - areas).max()
    return float(coef[0]), float(coef[1]), float(resid)


def cu_area_mm2(num_buffers: int) -> float:
    a_cu, a_buf, _ = fit_area_model()
    return a_cu + a_buf * (num_buffers - 1)


def area_overhead_pct(num_buffers: int) -> float:
    return 100.0 * cu_area_mm2(num_buffers) / BANK_AREA_MM2


def newton_overhead_pct() -> float:
    return 100.0 * NEWTON_AREA_MM2 / BANK_AREA_MM2
