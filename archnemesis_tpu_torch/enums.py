"""Integer flag/enum contracts shared with the NEMESIS file formats.

The integer values are a *data contract* (they appear in .inp/.set/.fla files
and HDF5 run files); they mirror the reference's enum modules
(``archnemesis/enum/*.py``). Enums are static configuration: they select
Python-level branches on the host, never a branch inside a kernel.
"""

from enum import IntEnum, IntFlag, auto


class WaveUnit(IntEnum):
    """ISPACE (reference enum/wave_unit_enum.py)."""

    Wavenumber_cm = 0
    Wavelength_um = 1


class EmissionType(IntEnum):
    """EMTYPE (reference enum/emission_type_enum.py)."""

    FLUORESCENCE = 0
    CHEMICAL = 1
    PHOTOLYSIS = 2


class SpectralCalculationMode(IntEnum):
    """ILBL (reference enum/spectral_calculation_mode_enum.py)."""

    K_TABLES = 0
    LINE_BY_LINE_RUNTIME = 1
    LINE_BY_LINE_TABLES = 2


class LayerType(IntEnum):
    """LAYTYP (reference enum/layer_type_enum.py)."""

    EQUAL_PRESSURE = 0
    EQUAL_LOG_PRESSURE = 1
    EQUAL_HEIGHT = 2
    EQUAL_PATH_LENGTH = 3
    BASE_PRESSURE = 4
    BASE_HEIGHT = 5


class LayerIntegrationScheme(IntEnum):
    """LAYINT (reference enum/layer_integration_scheme_enum.py)."""

    MID_PATH = 0
    ABSORBER_WEIGHTED_AVERAGE = 1


class InstrumentLineshape(IntEnum):
    """ISHAPE (reference enum/instrument_lineshape_enum.py)."""

    Square = 0
    Triangular = 1
    Gaussian = 2
    Hamming = 3
    Hanning = 4


class LowerBoundaryCondition(IntEnum):
    """LOWBC (reference enum/lower_boundary_condition_enum.py)."""

    THERMAL = 0
    LAMBERTIAN = 1
    HAPKE = 2
    OREN_NAYAR = 3


class RayleighScatteringMode(IntEnum):
    """IRAY (reference enum/rayleigh_scattering_mode_enum.py)."""

    NOT_INCLUDED = 0
    GAS_GIANT_ATM = 1
    CO2_DOMINATED_ATM = 2
    N2_O2_DOMINATED_ATM = 3
    JOVIAN_AIR = 4


class ScatteringCalculationMode(IntEnum):
    """ISCAT (reference enum/scattering_calculation_mode_enum.py)."""

    THERMAL_EMISSION = 0
    MULTIPLE_SCATTERING = 1
    INTERNAL_RADIATION_FIELD = 2
    SINGLE_SCATTERING_PLANE_PARALLEL = 3
    SINGLE_SCATTERING_SPHERICAL = 4
    INTERNAL_NET_FLUX = 5
    DOWNWARD_BOTTOM_FLUX = 6


class SpectraUnit(IntEnum):
    """IFORM (reference enum/spectra_unit_enum.py)."""

    Radiance = 0
    FluxRatio = 1
    TransitDepth = 2
    Integrated_spectral_power = 3
    Atmospheric_transmission = 4
    Normalised_radiance = 5
    Integrated_radiance = 6


class ZenithAngleOrigin(IntEnum):
    """IPZEN (reference enum/zenith_angle_origin_enum.py)."""

    BOTTOM = 0
    ALTITUDE_ZERO = 1
    TOP = 2


class PathObserverPointing(IntEnum):
    """Observer placement (reference enum/path_observer_pointing_enum.py)."""

    LIMB = 0
    NADIR = 1
    DISK = 2


class AmbientGas(IntEnum):
    """Broadening partner (reference enum/ambient_gas_enum.py)."""

    AIR = 0
    CO2 = 1
    H2 = 2


class SpectroscopicLineProfile(IntEnum):
    """IPROC (reference enum/spectroscopic_line_profile_enum.py)."""

    VOIGT = 0
    SUBLORENTZ_CO2_BROADENING = 1
    VANVLECK_WEISSKOPF = 2
    ROSENKRANTZ_BENREUVEN_FARIR = 3
    LORENTZ = 4
    LEVY1994 = 5
    ROSENKRANTZ_BENREUVEN = 6
    SUBLORENTZ_CO2_BROADENING_VENUS = 7
    DOPPLER = 12


class ParaH2Ratio(IntEnum):
    """INORMAL (reference enum/para_H2_ratio_enum.py)."""

    EQUILIBRIUM = 0
    NORMAL = 1


class AtmosphericProfileFormat(IntEnum):
    """AMFORM (reference enum/atmospheric_profile_format_enum.py)."""

    MOLECULAR_WEIGHT_DEFINED = 0
    CALC_MOLECULAR_WEIGHT_SCALE_VMR_TO_ONE = 1
    CALC_MOLECULAR_WEIGHT_DO_NOT_SCALE_VMR = 2


class PathCalc(IntFlag):
    """IMOD path-calculation flags (reference enum/path_calc_enum.py)."""

    WEIGHTING_FUNCTION = auto()
    NET_FLUX = auto()
    UPWARD_FLUX = auto()
    OUTWARD_FLUX = auto()
    DOWNWARD_FLUX = auto()
    CURTIS_GODSON = auto()
    THERMAL_EMISSION = auto()
    HEMISPHERE = auto()
    MULTIPLE_SCATTERING = auto()
    NEAR_LIMB = auto()
    SINGLE_SCATTERING_PLANE_PARALLEL = auto()
    SINGLE_SCATTERING_SPHERICAL = auto()
    ABSORBTION = auto()
    PLANCK_FUNCTION_AT_BIN_CENTRE = auto()
    BROADENING = auto()
