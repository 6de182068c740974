"""Area-box averages -> areas.nc (reference src/areasubs_diag.F).

Reads the `areas.limits` file (5 ocean + 5 atmosphere boxes by default;
grammar of src/areas.limits: counts then one line per coordinate vector
plus 3-letter labels) and computes mixed-layer temperature averages
over each box every monitoring interval. Partial cells at box edges get
fractional weights (areint, areasubs_diag.F:603-680); here each box
becomes a precomputed T-grid weight mask and the average is one masked
reduction."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class AreaBoxes:
    names_oc: List[str]
    w_oc: np.ndarray       # (nboxoc, nyto, nxto) weights
    names_at: List[str]
    w_at: np.ndarray       # (nboxat, nyta, nxta)


def _fnum(tok: str) -> float:
    return float(tok.replace("D", "e").replace("d", "e"))


def parse_areas_limits(path: str):
    """-> (names_oc, xlo, xhi, ylo, yhi, names_at, ...) from the
    areas.limits grammar (values before '!!' comments)."""
    rows = []
    with open(path) as f:
        for ln in f:
            body = ln.split("!!")[0].strip()
            if body:
                rows.append(body.split())
    nareoc = int(rows[0][0])
    xlo_oc = [_fnum(t) for t in rows[1][:nareoc]]
    xhi_oc = [_fnum(t) for t in rows[2][:nareoc]]
    ylo_oc = [_fnum(t) for t in rows[3][:nareoc]]
    yhi_oc = [_fnum(t) for t in rows[4][:nareoc]]
    names_oc = rows[5][:nareoc]
    nareat = int(rows[6][0])
    xlo_at = [_fnum(t) for t in rows[7][:nareat]]
    xhi_at = [_fnum(t) for t in rows[8][:nareat]]
    ylo_at = [_fnum(t) for t in rows[9][:nareat]]
    yhi_at = [_fnum(t) for t in rows[10][:nareat]]
    names_at = rows[11][:nareat]
    return ((names_oc, xlo_oc, xhi_oc, ylo_oc, yhi_oc),
            (names_at, xlo_at, xhi_at, ylo_at, yhi_at))


def _box_weights(xlo, xhi, ylo, yhi, x0, y0, d, nyt, nxt) -> np.ndarray:
    """Fractional-coverage weights of T cells for a box given in
    physical coordinates relative to (x0, y0)."""
    xl = np.arange(nxt) * d          # cell west edges (relative)
    yl = np.arange(nyt) * d
    covx = (np.minimum(xhi - x0, xl + d) - np.maximum(xlo - x0, xl))
    covy = (np.minimum(yhi - y0, yl + d) - np.maximum(ylo - y0, yl))
    covx = np.clip(covx / d, 0.0, 1.0)
    covy = np.clip(covy / d, 0.0, 1.0)
    return covy[:, None] * covx[None, :]


def build_area_boxes(model, path: str) -> AreaBoxes:
    cfg = model.cfg
    g = model.grids
    (oc, at) = parse_areas_limits(path)
    names_oc, xlo, xhi, ylo, yhi = oc
    w_oc = np.stack([
        _box_weights(xlo[m], xhi[m], ylo[m], yhi[m], 0.0, 0.0,
                     g.dxo, cfg.nyto, cfg.nxto)
        for m in range(len(names_oc))]) if names_oc else \
        np.zeros((0, cfg.nyto, cfg.nxto))
    names_at, xlo, xhi, ylo, yhi = at
    w_at = np.stack([
        _box_weights(xlo[m], xhi[m], ylo[m], yhi[m], 0.0, 0.0,
                     g.dxa, cfg.nyta, cfg.nxta)
        for m in range(len(names_at))]) if names_at else \
        np.zeros((0, cfg.nyta, cfg.nxta))
    return AreaBoxes(names_oc=list(names_oc), w_oc=w_oc,
                     names_at=list(names_at), w_at=w_at)


def area_averages(boxes: AreaBoxes, sst=None, ast=None):
    """-> (tavoc (nboxoc,), tavat (nboxat,)) masked means."""
    out_oc = out_at = None
    if sst is not None and len(boxes.names_oc):
        w = jnp.asarray(boxes.w_oc, sst.dtype)
        out_oc = (jnp.einsum("byx,yx->b", w, sst, precision="highest")
                  / jnp.sum(w, axis=(1, 2)))
    if ast is not None and len(boxes.names_at):
        w = jnp.asarray(boxes.w_at, ast.dtype)
        out_at = (jnp.einsum("byx,yx->b", w, ast, precision="highest")
                  / jnp.sum(w, axis=(1, 2)))
    return out_oc, out_at


class AreasWriter:
    """areas.nc: per-box T-average time series."""

    def __init__(self, path: str, boxes: AreaBoxes):
        from ..io.ncdf import make_writer as NcWriter
        self.boxes = boxes
        self.rec = 0
        w = NcWriter(path)
        w.dim("time", None)
        w.var("time", "f", ("time",), units="years")
        if boxes.names_oc:
            w.dim("areoc", len(boxes.names_oc))
            w.var("tavoc", "f", ("time", "areoc"), units="K")
        if boxes.names_at:
            w.dim("areat", len(boxes.names_at))
            w.var("tavat", "f", ("time", "areat"), units="K")
        self.w = w

    def append(self, tyrs, tavoc=None, tavat=None):
        self.w.append("time", self.rec, tyrs)
        if tavoc is not None:
            self.w.append("tavoc", self.rec, np.asarray(tavoc))
        if tavat is not None:
            self.w.append("tavat", self.rec, np.asarray(tavat))
        self.rec += 1

    def close(self):
        self.w.close()
