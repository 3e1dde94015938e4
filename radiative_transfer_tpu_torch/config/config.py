"""Configuration layer: .prm decks + auxiliary whitespace tables.

Reads the reference's own input decks unmodified. Grammar and defaults
mirror the reference exactly (reference: include/param.h:62-75 for the
key=value grammar, src/param.cpp:5-66 for typed coercion quirks, and
src/ParameterHandler.cpp:100-212 for the key set and defaults):

* lines whose first character is '#' are comments; otherwise the first
  '=' splits key from raw value (everything to end of line, untrimmed);
* duplicate keys keep the FIRST occurrence (std::map::insert semantics);
* int/double values are parsed from the leading characters only
  (std::stoi/std::stod stop at the first non-numeric char, so trailing
  inline comments are tolerated);
* bool values are true only if the raw value is exactly one of
  yes/Yes/true/True — trailing spaces make it false (replicated);
* psi_source is a whitespace-separated list filled row-major into an
  (M, G) matrix: entry k -> (m = k // G, g = k % G)
  (reference: src/ParameterHandler.cpp:116-133).

Port of radiative_transfer_tpu/config/config.py with the Python parser
only: the JAX package's optional native parser (native/rtio.cc) is
byte-identical to it, so the port reads every deck to the same Config.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional, Tuple

import numpy as np

_INT_RE = re.compile(r"^\s*([+-]?\d+)")
_FLOAT_RE = re.compile(r"^\s*([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)")
_TRUE_VALUES = ("yes", "Yes", "true", "True")


class PrmFile:
    """A parsed key=value .prm file with C++-faithful typed getters."""

    def __init__(self, path: str):
        self.path = path
        self.params: dict[str, str] = {}
        with open(path, "r") as fh:
            for line in fh:
                line = line.rstrip("\n").rstrip("\r")
                if len(line) > 0 and line[0] == "#":
                    continue
                idx = line.find("=")
                if idx != -1:
                    key = line[:idx]
                    value = line[idx + 1 :]
                    # std::map::insert keeps the first occurrence.
                    self.params.setdefault(key, value)

    def get_int(self, key: str, default: int) -> int:
        if key not in self.params:
            return default
        m = _INT_RE.match(self.params[key])
        if m is None:
            raise ValueError(f"cannot parse int from {key}={self.params[key]!r}")
        return int(m.group(1))

    def get_float(self, key: str, default: float) -> float:
        if key not in self.params:
            return default
        m = _FLOAT_RE.match(self.params[key])
        if m is None:
            raise ValueError(f"cannot parse float from {key}={self.params[key]!r}")
        return float(m.group(1))

    def get_bool(self, key: str, default: bool) -> bool:
        if key not in self.params:
            return default
        return self.params[key] in _TRUE_VALUES

    def get_str(self, key: str, default: str) -> str:
        return self.params.get(key, default)


def _read_table(path: str) -> np.ndarray:
    """Whitespace-separated stream of doubles (group bounds / kappa files)."""
    values = []
    with open(path, "r") as fh:
        for tok in fh.read().split():
            # Python's float() accepts digit-group underscores ("1_000")
            # which `stream >> double` (and strtod) do not — reject them
            # so the Python and native backends stop identically.
            if "_" in tok:
                break
            try:
                values.append(float(tok))
            except ValueError:
                break  # `stream >> double` stops at first bad token
    return np.asarray(values, dtype=np.float64)


def _resolve_aux(prm_path: str, name: str) -> str:
    """Resolve an auxiliary table path.

    The reference resolves '../prm/<name>' relative to its build dir
    (src/ParameterHandler.cpp:141,172); we resolve relative to the prm
    file's own directory, falling back to the raw name and CWD.
    """
    cands = [
        os.path.join(os.path.dirname(os.path.abspath(prm_path)), name),
        name,
        os.path.join("../prm", name),
    ]
    for c in cands:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(f"auxiliary table {name!r} not found near {prm_path!r}")


@dataclasses.dataclass(frozen=True)
class Config:
    """Frozen problem definition. Hashable (arrays as tuples), field for
    field the JAX package's Config.

    Field names and defaults mirror the reference key set
    (src/ParameterHandler.cpp:100-212).
    """

    M: int = 2                    # angular quadrature order (even)
    G: int = 1                    # number of energy groups
    efirst: float = 0.1           # first group right edge (keV)
    elast: float = 10.0           # last group right edge (keV)
    X: float = 1.0                # slab thickness (cm)
    N: int = 100                  # number of spatial cells
    bc_left_indicator: int = 2    # 0 vacuum, 1 source, 2 reflective
    bc_right_indicator: int = 1
    use_mg_equilib: bool = False
    psi_source: Tuple[Tuple[float, ...], ...] = ()   # (M, G) row tuples
    have_group_bounds: bool = False
    group_bounds: Tuple[float, ...] = ()             # (G+1,)
    have_group_absorption_opacities: bool = False
    group_kappa: Tuple[float, ...] = ()              # (G,)
    # Source-file names for the two tables above (display only — the
    # values are already loaded; ParameterHandler keeps and echoes them,
    # src/ParameterHandler.cpp:25,34).
    filename_group_bounds: str = ""
    filename_group_kappa: str = ""
    rho: float = 1.0              # material density (g/cm^3)
    kappa_grey: float = 1.0       # grey absorption opacity (cm^2/g)
    T: float = 1.0                # material temperature (keV)
    V: float = 0.0                # material velocity (cm/sh)
    use_correction: bool = False
    ts_method: int = 3            # 1 BE, 2 CN, 3 BDF2
    dt: float = 1.0e-5            # timestep (shakes)
    max_timesteps: int = 1000
    include_validation: bool = True
    # Reference-parity quirk toggle (not a reference deck key): the
    # reference's BDF2 phase-1 half_ends snapshot copies only in the mu<0
    # branch (solver.cpp:733), so the mu>0 half keeps the BE-predictor
    # output. False (default) replicates that; True uses the CN output
    # for BOTH halves — the symmetric scheme the code appears to intend.
    bdf2_symmetric_half: bool = False

    def __post_init__(self):
        # Fail fast with clear messages (the reference scatters these as
        # asserts and exit(1)s: GLQuad.h:20-21, ParameterHandler.cpp:146-149).
        if self.M <= 0 or self.M % 2 != 0:
            raise ValueError(f"M must be a positive even number, got {self.M}")
        if self.G <= 0:
            raise ValueError(f"G must be positive, got {self.G}")
        if self.N <= 0:
            raise ValueError(f"N must be positive, got {self.N}")
        if self.X <= 0:
            raise ValueError(f"X must be positive, got {self.X}")
        if self.dt <= 0:
            raise ValueError(f"dt must be positive, got {self.dt}")
        if self.ts_method not in (1, 2, 3):
            raise ValueError(
                f"ts_method must be 1 (BE), 2 (CN) or 3 (BDF2), got "
                f"{self.ts_method}"
            )
        for name in ("bc_left_indicator", "bc_right_indicator"):
            v = getattr(self, name)
            if v not in (0, 1, 2):
                raise ValueError(
                    f"{name} must be 0 (vacuum), 1 (source) or 2 "
                    f"(reflective), got {v}"
                )
        if self.have_group_bounds and len(self.group_bounds) != self.G + 1:
            raise ValueError(
                f"group_bounds needs G+1={self.G + 1} entries, got "
                f"{len(self.group_bounds)}"
            )
        if (self.have_group_absorption_opacities
                and len(self.group_kappa) != self.G):
            raise ValueError(
                f"group_kappa needs G={self.G} entries, got "
                f"{len(self.group_kappa)}"
            )

    @property
    def dx(self) -> float:
        return self.X / self.N

    @property
    def beta(self) -> float:
        from .. import constants

        return self.V / constants.SPEED_OF_LIGHT

    def psi_source_array(self) -> np.ndarray:
        if not self.psi_source:
            return np.zeros((self.M, self.G), dtype=np.float64)
        return np.asarray(self.psi_source, dtype=np.float64)

    def group_bounds_array(self) -> Optional[np.ndarray]:
        if not self.have_group_bounds:
            return None
        return np.asarray(self.group_bounds, dtype=np.float64)

    def group_kappa_array(self) -> Optional[np.ndarray]:
        if not self.have_group_absorption_opacities:
            return None
        return np.asarray(self.group_kappa, dtype=np.float64)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _parse_psi_source(raw: str, M: int, G: int) -> np.ndarray:
    """Replicates the stringstream fill loop (ParameterHandler.cpp:116-133)."""
    out = np.zeros((M, G), dtype=np.float64)
    counter = 0
    for tok in raw.split():
        try:
            val = float(tok)
        except ValueError:
            break
        m, g = counter // G, counter % G
        if m >= M:
            break
        out[m, g] = val
        counter += 1
    return out


def load_config(path: str, **overrides) -> Config:
    """Load a reference-format .prm deck (plus aux .txt tables) into a Config."""
    prm = PrmFile(path)

    # M/G overrides must take effect before psi_source is shaped (M, G).
    M = overrides.pop("M", None)
    if M is None:
        M = prm.get_int("M", 2)
    G = overrides.pop("G", None)
    if G is None:
        G = prm.get_int("G", 1)
    use_mg_equilib = prm.get_bool("use_mg_equilib", False)

    psi_source = np.zeros((M, G), dtype=np.float64)
    if not use_mg_equilib:
        raw = prm.get_str("psi_source", "no_sources_provided")
        psi_source = _parse_psi_source(raw, M, G)

    have_group_bounds = prm.get_bool("have_group_bounds", False)
    group_bounds: Tuple[float, ...] = ()
    fname_bounds = fname_kappa = ""
    if have_group_bounds:
        fname = prm.get_str("filename_group_bounds", "NA")
        # The reference stores (and echoes) the name with its "../prm/"
        # run-directory prefix prepended (ParameterHandler.cpp:141).
        fname_bounds = "../prm/" + fname
        vals = _read_table(_resolve_aux(path, fname))
        if vals.size != G + 1:
            raise ValueError(
                f"group bounds file {fname!r} has {vals.size} entries, "
                f"expected G+1={G + 1}"
            )
        group_bounds = tuple(vals.tolist())

    have_group_kappa = prm.get_bool("have_group_absorption_opacities", False)
    group_kappa: Tuple[float, ...] = ()
    if have_group_kappa:
        fname = prm.get_str("filename_group_kappa", "NA")
        fname_kappa = "../prm/" + fname  # ParameterHandler.cpp:172
        vals = _read_table(_resolve_aux(path, fname))
        if vals.size != G:
            raise ValueError(
                f"group kappa file {fname!r} has {vals.size} entries, "
                f"expected G={G}"
            )
        group_kappa = tuple(vals.tolist())

    cfg = Config(
        M=M,
        G=G,
        efirst=prm.get_float("efirst", 0.1),
        elast=prm.get_float("elast", 10.0),
        X=prm.get_float("X", 1.0),
        N=prm.get_int("N", 100),
        bc_left_indicator=prm.get_int("bc_left_indicator", 2),
        bc_right_indicator=prm.get_int("bc_right_indicator", 1),
        use_mg_equilib=use_mg_equilib,
        psi_source=tuple(map(tuple, psi_source.tolist())),
        have_group_bounds=have_group_bounds,
        group_bounds=group_bounds,
        have_group_absorption_opacities=have_group_kappa,
        group_kappa=group_kappa,
        filename_group_bounds=fname_bounds,
        filename_group_kappa=fname_kappa,
        rho=prm.get_float("rho", 1.0),
        kappa_grey=prm.get_float("kappa_grey", 1.0),
        T=prm.get_float("T", 1.0),
        V=prm.get_float("V", 0.0),
        use_correction=prm.get_bool("use_correction", False),
        ts_method=prm.get_int("ts_method", 3),
        dt=prm.get_float("dt", 0.00001),
        max_timesteps=prm.get_int("max_timesteps", 1000),
        include_validation=prm.get_bool("include_validation", True),
        # Extension key (not in the reference grammar; defaults to the
        # reference-parity behavior when absent).
        bdf2_symmetric_half=prm.get_bool("bdf2_symmetric_half", False),
    )
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
