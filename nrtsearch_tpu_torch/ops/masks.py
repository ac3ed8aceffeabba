"""Filter masks over columnar doc values (counterpart:
nrtsearch_tpu/ops/masks.py ``range_mask``, ``eq_mask``, ``in_set_mask``,
``exists_mask``, the geo masks and ``doc_polygons_contain_point``).

Elementwise compares over a segment's [capacity] column give bool masks that
AND/OR/NOT together. Columns are f32, f64 or int32 ordinals; bounds and
targets are 0-d tensors or Python numbers of the column's precision (the
callers round f32 bounds through ``np.float32`` first, as the reference
does).

The geo masks read a LAT_LON column as the reference keeps it on its
device: f32 [capacity, 2] (lat, lon), with the f64 values on the host.
They compute in f32 in the reference's operation order, with each f32
constant (pi/180, the earth's radius, a query point) rounded as JAX rounds
it. The transcendental functions (sin, cos, arcsin, sqrt) are torch's, not
XLA's: a distance may differ from the reference's in its last bits, so a
doc within a few ulp of a radius may land on the other side of it.
``doc_polygons_contain_point`` reads a POLYGON column, f32 [capacity, V, 2]
of NaN-separated closed rings per doc.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from nrtsearch_tpu_torch.device import scalar_f32


def range_mask(values: torch.Tensor, present: torch.Tensor, lower, upper,
               lower_inclusive: bool, upper_inclusive: bool) -> torch.Tensor:
    lo_ok = values >= lower if lower_inclusive else values > lower
    hi_ok = values <= upper if upper_inclusive else values < upper
    return lo_ok & hi_ok & present


def eq_mask(values: torch.Tensor, present: torch.Tensor, target) -> torch.Tensor:
    return (values == target) & present


def in_set_mask(values: torch.Tensor, present: torch.Tensor,
                targets: Sequence) -> torch.Tensor:
    """Docs whose value is any of ``targets`` (a short sequence of numbers
    or a 1-d tensor), and present."""
    hit = torch.zeros_like(present)
    for t in targets:
        hit |= values == t
    return hit & present


def exists_mask(present: torch.Tensor) -> torch.Tensor:
    return present


def geo_bounding_box_mask(latlon: torch.Tensor, present: torch.Tensor, min_lat: float,
                          max_lat: float, min_lon: float, max_lon: float) -> torch.Tensor:
    dev = latlon.device
    lat, lon = latlon[:, 0], latlon[:, 1]
    ok = (lat >= scalar_f32(min_lat, dev)) & (lat <= scalar_f32(max_lat, dev))
    if min_lon <= max_lon:
        ok &= (lon >= scalar_f32(min_lon, dev)) & (lon <= scalar_f32(max_lon, dev))
    else:  # crosses the dateline
        ok &= (lon >= scalar_f32(min_lon, dev)) | (lon <= scalar_f32(max_lon, dev))
    return ok & present


def _parity(lat, lon, y1, x1, y2, x2) -> torch.Tensor:
    """Odd ray-crossing count per point over the edges (x1, y1)-(x2, y2)
    (the reference's ``cond & (lon < x_int)`` sum); NaN edges never cross."""
    cond = (y1 > lat) != (y2 > lat)
    dy = y2 - y1
    denom = torch.where(dy == 0, torch.full_like(dy, float(np.float32(1e-12))), dy)
    x_int = x1 + (lat - y1) * (x2 - x1) / denom
    crossings = (cond & (lon < x_int)).sum(dim=1)
    return (crossings % 2) == 1


def point_in_polygon_mask(latlon: torch.Tensor, present: torch.Tensor,
                          polygon: torch.Tensor) -> torch.Tensor:
    """Ray-casting point-in-polygon over one ring of f32 [V, 2] (lat, lon)
    vertices, closed or open."""
    lat, lon = latlon[:, 0:1], latlon[:, 1:2]
    y1, x1 = polygon[:, 0][None, :], polygon[:, 1][None, :]
    y2 = torch.roll(polygon[:, 0], -1)[None, :]
    x2 = torch.roll(polygon[:, 1], -1)[None, :]
    return _parity(lat, lon, y1, x1, y2, x2) & present


def point_in_rings_mask(latlon: torch.Tensor, present: torch.Tensor,
                        rings: torch.Tensor) -> torch.Tensor:
    """Even-odd point-in-polygon over NaN-separated closed rings (an outer
    ring and its holes), f32 [V, 2]."""
    lat, lon = latlon[:, 0:1], latlon[:, 1:2]
    y1, x1 = rings[:-1, 0][None, :], rings[:-1, 1][None, :]
    y2, x2 = rings[1:, 0][None, :], rings[1:, 1][None, :]
    return _parity(lat, lon, y1, x1, y2, x2) & present


def doc_polygons_contain_point(verts: torch.Tensor, present: torch.Tensor, lat,
                               lon) -> torch.Tensor:
    """Docs whose indexed POLYGON contains the query point (the reference's
    GeoPointQuery against PolygonfieldDef): one even-odd parity count over
    every doc's edges, the query point's coordinates rounded to f32."""
    dev = verts.device
    y1, x1 = verts[:, :-1, 0], verts[:, :-1, 1]          # [D, V-1]
    y2, x2 = verts[:, 1:, 0], verts[:, 1:, 1]
    return _parity(scalar_f32(lat, dev), scalar_f32(lon, dev), y1, x1, y2, x2) & present


_DEG2RAD = float(np.float32(np.pi / 180))   # jnp.deg2rad's f32 constant
_TWO_R_EARTH = 2 * 6371008.7714             # a Python product, as the reference's


def haversine_meters(latlon: torch.Tensor, center_lat, center_lon) -> torch.Tensor:
    """Per-doc haversine distance in meters from an f32 [D, 2] column to a
    point (reference: geo/GeoUtils.arcDistance), in f32."""
    dev = latlon.device
    rad = scalar_f32(_DEG2RAD, dev)
    lat = latlon[:, 0] * rad
    lon = latlon[:, 1] * rad
    clat = scalar_f32(center_lat, dev) * rad
    clon = scalar_f32(center_lon, dev) * rad
    two = scalar_f32(2.0, dev)
    s_lat = torch.sin((lat - clat) / two)
    s_lon = torch.sin((lon - clon) / two)
    a = s_lat * s_lat + torch.cos(lat) * torch.cos(clat) * (s_lon * s_lon)
    return scalar_f32(_TWO_R_EARTH, dev) * torch.asin(torch.sqrt(a))


def geo_radius_mask(latlon: torch.Tensor, present: torch.Tensor, center_lat,
                    center_lon, radius_meters) -> torch.Tensor:
    """Haversine distance filter (GeoRadiusQuery)."""
    dist = haversine_meters(latlon, center_lat, center_lon)
    return (dist <= scalar_f32(radius_meters, latlon.device)) & present
