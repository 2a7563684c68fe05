"""Instrument convolution of calculated spectra: the FWHM=0 channel mode.

Port of ``conv_channel_interp`` from the JAX package's
``ops/convolution.py`` (reference ``Measurement_0.py`` conv:2428-2434).
The ILS and filter modes come with the instrument slice.
"""

from archnemesis_tpu_torch.utils.interp import interp1d_extrap


def conv_channel_interp(wave, spec, vconv):
    """FWHM=0 channel mode: k-tables already include the filter, so linear
    interpolation of the calc grid onto the convolution wavelengths."""
    return interp1d_extrap(wave, spec, vconv)
