"""Physical constants (SI and cgs).

Values match the reference implementation (`archnemesis/Data/constants.py`) so
that synthetic spectra agree at rtol 1e-5. CODATA 2018 where exact.
"""

K_B = 1.380649e-23  # J/K Boltzmann constant
K_B_CGS = 1.380649e-16  # erg/K

SIGMA_SB = 5.67037e-8  # W m-2 K-4 Stefan-Boltzmann

R_GAS = 8.31446261815324  # J mol-1 K-1 universal gas constant
R_GAS_CGS = 8.31446261815324e7  # erg mol-1 K-1

G_GRAV = 6.67199976e-11  # m3 kg-1 s-2 gravitational constant (NEMESIS value)

C_LIGHT = 2.99792458e8  # m/s
C_LIGHT_CGS = 2.99792458e10  # cm/s

H_PLANCK = 6.62607015e-34  # J s
H_PLANCK_CGS = 6.62607015e-27  # erg s

REF_TEMP = 296.0  # K reference temperature for line strengths

C2 = C_LIGHT * H_PLANCK / K_B  # m K   second radiation constant
C2_CGS = C_LIGHT_CGS * H_PLANCK_CGS / K_B_CGS  # cm K

N_AVOGADRO = 6.02214129e23  # mol^-1 (value used by reference Data/constants.py)
AVOGAD = 6.02214076e23  # mol^-1 (CODATA-exact value used by reference Layer_0.py:36)

ATM = 101325.0  # Pa  standard atmosphere
K_B_OVER_ATM = K_B / ATM

AMU = 1.66054e-27  # kg  atomic mass unit (NEMESIS value)

AU_M = 1.49598e11  # m astronomical unit
