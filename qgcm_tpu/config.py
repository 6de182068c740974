"""Model configuration.

Replaces the reference's three-way split of compile-time grid PARAMETERs
(src/parameters_data.F:41-88), CPP feature flags (src/make.config:9-46)
and the ordered runtime parameter file (src/input.params read by
src/in_param.f). Here everything is one runtime config; grid sizes become
jit-static (they determine traced array shapes).

Grid relationships follow src/parameters_data.F:81-99:
  atmosphere T-grid nxta x nyta; p-grid is (+1) in each direction.
  The ocean occupies nxaooc x nyaooc atmospheric cells at refinement
  ndxr, so nxto = ndxr*nxaooc, and is offset by (nx1, ny1) cells to
  centre it in the atmospheric domain.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class OceanConfig:
    """Oceanic QG layer parameters (input.params 'Oceanic QG layer' block)."""

    nlo: int = 3
    dxo: float = 5.0e3            # ocean grid spacing (m)
    delek: float = 2.0            # bottom Ekman layer thickness (m)
    bccooc: float = 0.2           # mixed BC coefficient (nondim.)
    hoc: Tuple[float, ...] = (350.0, 750.0, 2900.0)     # layer thicknesses (m)
    gpoc: Tuple[float, ...] = (0.015, 0.0075)           # reduced gravities (m s^-2)
    tabsoc: Tuple[float, ...] = (287.0, 282.0, 276.0)   # layer potential temps (K)
    ah2oc: Tuple[float, ...] = (0.0, 0.0, 0.0)          # Del-sqd coeffts (m^2 s^-1)
    ah4oc: Tuple[float, ...] = (2.0e9, 2.0e9, 2.0e9)    # Del-4th coeffts (m^4 s^-1)


@dataclass(frozen=True)
class AtmosConfig:
    """Atmospheric QG layer parameters."""

    nla: int = 3
    bccoat: float = 1.0
    hat: Tuple[float, ...] = (2000.0, 3000.0, 4000.0)
    gpat: Tuple[float, ...] = (1.2, 0.4)
    tabsat: Tuple[float, ...] = (330.0, 340.0, 350.0)
    ah4at: Tuple[float, ...] = (1.5e14, 1.5e14, 1.5e14)


@dataclass(frozen=True)
class MixedLayerConfig:
    """Mixed layer parameters (input.params 'Mixed layer' block)."""

    xlamda: float = 35.0          # sensible+latent transfer coefft (W m^-2 K^-1)
    hmoc: float = 100.0           # fixed ocean mixed layer depth (m)
    st2d: float = 100.0           # SST Del-sqd diffusivity (m^2 s^-1)
    st4d: float = 2.0e9           # SST Del-4th diffusivity (m^4 s^-1)
    hmat: float = 1000.0          # fixed atmos mixed layer depth (m)
    hmamin: float = 100.0         # minimum atmos m.l. depth (m)
    ahmd: float = 2.0e5           # atmos hmix diffusivity (m^2 s^-1)
    at2d: float = 2.5e4           # AST Del-sqd diffusivity (m^2 s^-1)
    at4d: float = 2.0e14          # AST Del-4th diffusivity (m^4 s^-1)
    hmadmp: float = 0.15          # atmos m.l. damping constant


@dataclass(frozen=True)
class RadiationConfig:
    """Radiation scheme parameters (input.params 'Radiation' block)."""

    fsbar: float = -210.0         # mean radiative forcing (W m^-2)
    fspamp: float = 80.0          # perturbation magnitude (W m^-2), >= 0
    zm: float = 200.0             # optical depth in a.m.l. (m)
    zopt: Tuple[float, ...] = (2.0e4, 2.0e4, 3.0e4)   # optical depth per layer (m)
    gamma: float = 1.0e-2         # adiabatic lapse rate (K m^-1)


@dataclass(frozen=True)
class SpongeConfig:
    """k247 sponge layer (reference src/parameters_data.F:140-145,
    src/q-gcm.F:1144-1182, src/qgosubs.F:203-205)."""

    enabled: bool = False
    c1_spl: float = -2.5e-5
    l_spl: float = 4.0e5
    nospl_in_ewbdy: bool = False  # sponge only on N-S boundaries


@dataclass(frozen=True)
class ModelConfig:
    """Full model configuration (grid + physics + feature flags)."""

    # --- grid dimensioning (reference src/parameters_data.F:41-58) ---
    nxta: int = 384
    nyta: int = 96
    nxaooc: int = 60
    nyaooc: int = 60
    ndxr: int = 16

    # --- rotation (src/parameters_data.F:103-105) ---
    fnot: float = 9.37456e-5      # Coriolis parameter (rad s^-1)
    beta: float = 1.7536e-11      # df/dy (rad s^-1 m^-1)

    # --- timestepping ---
    dta: float = 180.0            # atmos timestep (s)
    nstr: int = 3                 # dto = nstr*dta

    # --- coupling / bulk constants ---
    cdat: float = 1.3e-3          # quadratic drag coefficient
    rhoat: float = 1.0            # atmos density (kg m^-3)
    rhooc: float = 1.0e3          # ocean density (kg m^-3)
    cpat: float = 1.0e3           # atmos specific heat (J kg^-1 K^-1)
    cpoc: float = 4.0e3           # ocean specific heat (J kg^-1 K^-1)
    xcexp: float = 1.0            # coupling coefficient x
    ycexp: float = 1.0            # coupling coefficient y

    # --- sub-configs ---
    ocean: OceanConfig = field(default_factory=OceanConfig)
    atmos: AtmosConfig = field(default_factory=AtmosConfig)
    mixed: MixedLayerConfig = field(default_factory=MixedLayerConfig)
    radiation: RadiationConfig = field(default_factory=RadiationConfig)
    sponge: SpongeConfig = field(default_factory=SpongeConfig)

    # --- feature flags (reference CPP defines, src/make.config:9-46) ---
    ocean_only: bool = False
    atmos_only: bool = False
    cyclic_ocean: bool = False
    sb_hflux: bool = False
    nb_hflux: bool = False
    tau_udiff: bool = False
    no_oml: bool = False          # k247 no_oml_k247

    # --- numerics ---
    dtype: str = "float64"        # dtype of stepped fields
    # Compute BOTH fluids' mixed layers in float64 on float32 runs
    # (store stays float32). None = auto: ON for float32 models. The
    # mixed-layer clamps (ocean SST convection floor omlsubs.F:115-118;
    # atmos min-thickness fixer amlsubs.F:118-150) are non-smooth
    # switches; under f32 roundoff they can decouple the leapfrog time
    # levels at a switching front and the advection-diffusion then
    # runs away EXPLOSIVELY (measured: a healthy forced-channel
    # realisation went 9 K -> NaN within 160 steps at day 87; the
    # identical state continued in f64 stays bounded, and computing
    # just the mixed layer in f64 removes the runaway -- round-5
    # notes). The reference never sees this because Fortran Q-GCM is
    # double precision throughout. Resolved by ml_f64_enabled().
    ml_f64: bool = None

    # ------------------------------------------------------------------
    # Derived grid quantities (reference src/parameters_data.F:77-99)
    # ------------------------------------------------------------------
    @property
    def nxpa(self) -> int:
        return self.nxta + 1

    @property
    def nypa(self) -> int:
        return self.nyta + 1

    @property
    def nxto(self) -> int:
        return self.ndxr * self.nxaooc

    @property
    def nyto(self) -> int:
        return self.ndxr * self.nyaooc

    @property
    def nxpo(self) -> int:
        return self.nxto + 1

    @property
    def nypo(self) -> int:
        return self.nyto + 1

    @property
    def nxtaor(self) -> int:
        return self.nxta * self.ndxr

    @property
    def nytaor(self) -> int:
        return self.nyta * self.ndxr

    @property
    def nxpaor(self) -> int:
        return self.nxtaor + 1

    @property
    def nypaor(self) -> int:
        return self.nytaor + 1

    @property
    def nx1(self) -> int:
        return 1 + (self.nxta - self.nxaooc) // 2

    @property
    def ny1(self) -> int:
        return 1 + (self.nyta - self.nyaooc) // 2

    @property
    def atnorm(self) -> float:
        return 1.0 / (self.nxta * self.nyta)

    @property
    def ocnorm(self) -> float:
        return 1.0 / (self.nxto * self.nyto)

    @property
    def dxa(self) -> float:
        return self.ndxr * self.ocean.dxo

    @property
    def dto(self) -> float:
        return self.nstr * self.dta

    @property
    def nlo(self) -> int:
        return self.ocean.nlo

    @property
    def nla(self) -> int:
        return self.atmos.nla

    def validate(self) -> "ModelConfig":
        """Consistency checks mirroring reference src/q-gcm.F:244-375."""
        oc, at = self.ocean, self.atmos
        if self.ocean_only and self.atmos_only:
            raise ValueError("ocean_only and atmos_only are mutually exclusive")
        if self.sb_hflux and self.nb_hflux:
            raise ValueError("sb_hflux and nb_hflux are mutually exclusive")
        if self.sb_hflux and self.fnot < 0:
            raise ValueError("sb_hflux requires northern hemisphere (fnot > 0)")
        if self.nb_hflux and self.fnot > 0:
            raise ValueError("nb_hflux requires southern hemisphere (fnot < 0)")
        if oc.nlo < 2 or at.nla < 2:
            raise ValueError("need at least 2 layers in each fluid")
        if self.cyclic_ocean and self.nxta != self.nxaooc:
            raise ValueError("cyclic ocean requires nxta == nxaooc")
        if not self.cyclic_ocean and self.nxta < self.nxaooc:
            raise ValueError("need nxta >= nxaooc")
        if self.nyta < self.nyaooc:
            raise ValueError("need nyta >= nyaooc")
        if len(oc.hoc) != oc.nlo or len(oc.gpoc) != oc.nlo - 1:
            raise ValueError("ocean layer parameter lengths inconsistent with nlo")
        if len(at.hat) != at.nla or len(at.gpat) != at.nla - 1:
            raise ValueError("atmos layer parameter lengths inconsistent with nla")
        if len(oc.tabsoc) != oc.nlo or len(at.tabsat) != at.nla:
            raise ValueError("layer temperature lengths inconsistent")
        if len(oc.ah2oc) != oc.nlo or len(oc.ah4oc) != oc.nlo:
            raise ValueError(
                "ocean viscosity lengths (ah2oc/ah4oc) inconsistent "
                f"with nlo={oc.nlo}")
        if len(at.ah4at) != at.nla:
            raise ValueError(
                f"atmos viscosity length (ah4at) inconsistent with "
                f"nla={at.nla}")
        if len(self.radiation.zopt) != at.nla:
            raise ValueError(
                f"radiation.zopt needs one optical depth per atmos "
                f"layer (nla={at.nla}, got {len(self.radiation.zopt)})")
        if self.radiation.fspamp < 0:
            raise ValueError("fspamp must be non-negative")
        return self

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------
# Canonical experiment presets (reference examples/*/)
# ----------------------------------------------------------------------

def ml_f64_enabled(cfg: ModelConfig) -> bool:
    """Resolve ModelConfig.ml_f64 (None = auto: on for float32)."""
    if cfg.ml_f64 is not None:
        return cfg.ml_f64
    return cfg.dtype == "float32"


def double_gyre_ocean_only(**overrides) -> ModelConfig:
    """examples/double_gyre_ocean_only: 3-layer box ocean, 5 km grid,
    80 km atmosphere grid (atmosphere inactive)."""
    cfg = ModelConfig(ocean_only=True, cyclic_ocean=False)
    return cfg.replace(**overrides).validate()


def double_gyre_coupled(**overrides) -> ModelConfig:
    """examples/double_gyre_coupled: as dg_oo but fully coupled."""
    cfg = ModelConfig(ocean_only=False, cyclic_ocean=False)
    return cfg.replace(**overrides).validate()


def southern_ocean_ocean_only(**overrides) -> ModelConfig:
    """examples/southern_ocean_ocean_only: cyclic channel ocean at 55S."""
    cfg = ModelConfig(
        nxta=288, nyta=108, nxaooc=288, nyaooc=36, ndxr=16,
        fnot=-1.19467e-4, beta=1.31301e-11,
        ocean_only=True, cyclic_ocean=True,
        nb_hflux=True,
    )
    return cfg.replace(**overrides).validate()


def southern_ocean_coupled(**overrides) -> ModelConfig:
    cfg = southern_ocean_ocean_only(ocean_only=False)
    return cfg.replace(**overrides).validate()


def k247_default(**overrides) -> ModelConfig:
    """The k247 fork's default: ocean-only cyclic 960x960 1.5-layer ocean
    at 4 km, 24N (reference src/parameters_data.F:46,54,105,110 and
    src/input.params:34,40,44,110-112)."""
    cfg = ModelConfig(
        nxta=60, nyta=60, nxaooc=60, nyaooc=60, ndxr=16,
        fnot=5.92e-5, beta=2.08e-11,
        dta=144.0, nstr=3,
        ocean=OceanConfig(
            nlo=2, dxo=4.0e3, delek=0.0, bccooc=0.2,
            hoc=(800.0, 3.2e20), gpoc=(0.01,),
            tabsoc=(287.0, 282.0),
            ah2oc=(0.0, 0.0), ah4oc=(0.0, 0.0),
        ),
        ocean_only=True, cyclic_ocean=True,
        sponge=SpongeConfig(enabled=True),
    )
    return cfg.replace(**overrides).validate()


def natl_1km(**overrides) -> ModelConfig:
    """src/parameters_data.F.NAtl.1km: 4800x4800 ocean at 1 km under a
    768x192 atmosphere at 40 km (the multi-host scaling config)."""
    cfg = ModelConfig(
        nxta=768, nyta=192, nxaooc=120, nyaooc=120, ndxr=40,
        fnot=9.37456e-5, beta=1.7536e-11,
        dta=36.0, nstr=3,
        ocean=OceanConfig(dxo=1.0e3),
    )
    return cfg.replace(**overrides).validate()


PRESETS = {
    "double_gyre_ocean_only": double_gyre_ocean_only,
    "double_gyre_coupled": double_gyre_coupled,
    "southern_ocean_ocean_only": southern_ocean_ocean_only,
    "southern_ocean_coupled": southern_ocean_coupled,
    "k247_default": k247_default,
    "natl_1km": natl_1km,
}
