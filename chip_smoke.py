#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``archnemesis_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda``); exits non-zero
without them. Phases, each of which fails the run on its own:

1. device and build: the card's name and power limit, the torch/CUDA
   versions; every kernel library built from the checkout, one nvcc per
   source, all started together: the random-overlap kernels (primal and
   fused primal + tangent kernel,
   ``archnemesis_tpu_torch/csrc/overlap_combine.cu``),
   the line-by-line cross-section (``csrc/lbl_cross_section.cu``), the
   combine's A/B variants (``csrc/overlap_variants.cu``), the FMA-peak
   probe (``csrc/fma_peak.cu``) and the correlated-k Jacobian's tangent
   passes (``csrc/tangent_ops.cu``), with the build times and ptxas' register
   reports; beside them the host fixed-width decoder
   (``native/src/fixed_width.cpp``, g++) with the compiler's version and
   its build time;
2. kernel vs plain: the kernel against its plain PyTorch version at NG
   10, 20 and 32 (the largest the kernel takes) in float32 (rtol 2e-5,
   atol 1e-7, the JAX package's own Pallas-vs-XLA bound) and float64
   (rtol 1e-12), with tied and all-zero rows, and at the headline's
   581,632 rows; then at NG 1, 2, 3, 7, 20, 31, 32 on 4,099 rows (a
   ragged last block) with rows unsorted along g in a, in b and in both,
   heavy ties and all-zero rows (``combine_cases``). Every float32 kernel
   result is also held to the float64 result of the same inputs at the
   float32 bound, which alone holds at NG=32: there the plain float32
   version's own error nears the bound. Both float32 versions' errors
   against float64 are printed. At full size two launches must give equal
   bits; then the kernel is timed beside the plain version at R = 79,872,
   NG = 10 (the scattering headline's shape) and at the full size in
   float64;
3. the golden deck (``tests/fixtures/jupiter_nadir``) read with the port's
   readers: float64 layer optical depths and convolved spectrum within
   rtol 1e-5 of ``tests/goldens/jupiter_nadir_fm.npz``; float32
   (``cast_deck``) within 1e-4 max / 1e-5 median relative error of the
   float64 spectrum;
4. the headline forward: 8192 waves x 20 g x 71 layers x 7 gases in
   float32, which must launch the kernel 6 times per forward and agree
   with its float64 counterpart within the same float32 bounds; its
   median time over 12 runs, waves/s and peak device memory;
5. tangent kernel vs plain: the fused primal + tangent combine against its
   plain PyTorch version at NG 10, 20, 32, T = 1, 3, 81 tangents, R = 4096
   and the retrieval's 39,689 rows, on tie-free rows (pair sums on an
   integer lattice, so float32 and float64 sort them alike): float64 at
   rtol 1e-12 of the tangents' peak, float32 at ``tangent_f32_tol`` (2e-5
   of the peak up to NG = 10, 6.8e-5 at NG = 32) against the float64 result
   of the same inputs, and against the float32 plain version up to NG =
   20; the fused primal equal to the primal kernel's bit for bit (they
   share its code). Then the hard rows of phase 2 (``combine_cases`` at
   NG 1, 2, 3, 7, 20, 31, 32 on 4,099 rows: a ragged last block, rows
   unsorted along g, ties, all-zero rows): the primal bit for bit and the
   tangents finite (on tied keys they depend on the order of equal keys),
   and tie-free rows shuffled along g, whose tangents are held to the
   plain version as above. At T = 81, R = 39,689, NG = 20 in both types
   two launches and a launch replayed from a ``torch.cuda.CUDAGraph`` give
   equal bits; the time beside the bound, and the time of a launch with no
   tangents beside kernel 1's;
6. the retrieval on the card, through ``retrievals.make_retrieval_setup``
   and ``retrieval_nemesis`` with ``device="cuda"``: on ``jupiter_nadir``
   in float64 the a priori and measurement vector, ``forward_fn(XN)`` and
   one JVP column against the reference goldens, the ``jacfwd`` column
   equal to that JVP, and exactly 6 fused launches per forward-plus-Jacobian
   evaluation (81 tangents); on a copy of ``jupiter_fdret`` the whole
   retrieval against ``tests/goldens/jupiter_retrieval.npz``; then the
   median time and peak memory of one evaluation in float64 and float32,
   float32 against float64 (spectrum inside the float32 bounds, Jacobian
   within ``JAC_F32_BOUND`` of each column's peak), and the wall-clock of a
   3-iteration retrieval;
7. LBL kernel vs plain: the cross-section kernel against its plain
   PyTorch version and the reference (``tests/goldens/co_lbl.npz``, line
   data from the ``.npz`` export: the card's machine has no h5py) on that
   golden's grid and cases, for all six lineshapes with s_floor > 0, no
   shift and the iso-0 factor, at block widths 128, 200, 1 and 512 and
   with blocks that hold no lines, and in a pressure-shift case that moves
   line centres across the blocks' core/wing boundaries
   (``SHIFT_CASE_STATE``; its class changes are counted and must be some):
   float64 within rtol 1e-10, float32 within 5e-5 max / 2e-5 median
   relative error of float64 (the JAX package's co_runtime_voigt bound);
   in the shift case float32 within that bound of the plain float32
   version, and against float64 no further off than the plain float32
   version plus the bound (both errors printed);
   at the full-width configuration (80,000 waves x 5,092 lines x 40
   layers) two float32 launches equal bit for bit, float32 against the
   plain version and, on 2 layers, float64 against the plain float64
   version; the kernel's time beside its operation bound
   (``lbl_bound_ms``), the device times of its line and pair passes
   (``torch.profiler``), the (block, line) class counts; the plain
   version's time over all 40 layers;
8. the runtime golden deck (``tests/fixtures/co_runtime``, copied with its
   line data pointed at the export) through ``load_deck``: float64 TAUGAS
   and SPECONV within rtol 1e-7 / 1e-6 of ``co_runtime_fm.npz``, float32
   within the float32 bound, 1 launch per forward;
9. the LBL headline forward (``synthetic.lbl_headline``, float32): 1
   launch per forward and no packing of the static kernel inputs after
   the first, median time of 12 forwards, waves/s, peak memory, float32
   within the float32 bound of the float64 forward;
10. the runtime retrieval on the card: ``forward_fn(xa)`` and
    ``forward_and_jacobian`` (15 tangents) in float64 equal to the port's
    CPU result, 1 launch per evaluation, the wall-clock and phi history of
    ``retrieval_nemesis(niter=3)`` on the card and on the CPU;
11. the float32 FMA-peak probe (``csrc/fma_peak.cu``): the kernel equal to
    its plain version bit for bit on random input, the FFMA count of its
    SASS, then the probe tool's measurement at 72,704 x 512 (the main
    path: ``tools/fma_peak.measure``, 24 launches): TFLOP/s and the share
    of the data-sheet peak;
12. the combine's A/B variants (``csrc/overlap_variants.cu``, the
    warp-per-row code of kernel 1t taken apart stage by stage, which gives
    kernel 1's bits): every mode against its plain version at NG 4 and 32
    (65,536 rows) and at the tool's R = 581,632, NG
    = 20 (``sortonly`` and ``rollonly`` bit for bit, and equal to
    ``torch.topk`` and ``torch.roll``; ``full`` equal to kernel 1 bit for
    bit and to itself at every row tile; ``full`` and ``edges`` within
    ``variant_f32_tol`` of each row's peak of the float64 result and
    within three times it of the float32 plain version); then the variants
    tool (the main path: ``tools/overlap_variants.run``) with ms per mode
    beside kernel 1's, its bound and library time (``torch.topk``,
    ``torch.roll``), ms per rows per block, and the row code's split: full
    - sortonly (its scan and rebin) and full - edges (the walk against the
    search);
13. the LBL headline's synthesis as 4 logical wave shards through the
    packed entry (``ops/lbl_cuda.py:lbl_kernel_packed``): the shards'
    concatenation equal to the unsharded kernel bit for bit and, on all 40
    layers, within the float32 bound of the plain version; ms per shard
    launch beside each shard's bound, its halo (lines per shard); then the
    sharded LBL headline forward (the main path: 4 launches) against the
    unsharded one;
14. the wave-sharded forward with ``torch.distributed`` on the card: a
    one-rank NCCL group started through ``parallel.multihost.initialize``
    with a ``file://`` store; ``jupiter_nadir`` in float64, forward and 3
    Jacobian columns, sharded over 4 wave shards (k-tables) against
    unsharded, and the ``co_runtime`` retrieval set-up with its runtime
    deck sharded over 4 shards against unsharded (forward and Jacobian),
    every spectrum gathered through the group;
15. the scattering goldens on the card in float64: the adding-doubling
    core (``rt/scattering.py:scloud11wave``) on ``scatter_core.npz``
    (thermal, solar, Lambert surface) at rtol 1e-10, the Hapke, Oren-Nayar
    and Lambert BRDFs and the single-scattering kernel on
    ``surface_singlescat.npz`` at rtol 1e-10, the ``jupiter_scatter`` deck's
    multiple-scattering forward (layer optical depths at rtol 1e-5, SPECONV
    at 1e-6 of ``jupiter_scatter_fm.npz``), its single-scattering forward
    (``jupiter_singlescat_fm.npz``, 1e-6) and the four surfaces of
    ``jupiter_brdf_fm.npz`` (1e-5); float32 within ``SCAT_F32_BOUND`` (5e-4
    of the peak) of float64 on the core and on both deck forwards;
16. the scattering headline (``synthetic.scattering_headline``:
    ``bench.py``'s scattering workload at full width, 2048 waves x 10 g x
    39 layers x 7 gases, NMU=5, NF=2, NPHI=100, float32): 6 launches of the
    primal kernel per forward, the host reads of the data-dependent loops,
    float32 within 5e-4 of the float64 forward of the same inputs; median
    of 12 forwards, waves/s and peak memory at the 128-wave tile and in one
    2048-wave tile (the two within 5e-4); then NMU=15 (``leggauss(30)``) at
    the 128-wave tile in float32 and float64: finite, within 5e-4, time and
    memory of one forward;
17. the scattering retrieval on the card (``jupiter_scatter``: models 0,
    47 and 444, 92 state elements), float64: ``forward_fn(xa)`` equal to
    the port's CPU result at rtol 1e-9; one ``forward_and_jacobian``:
    every column finite, each model's columns nonzero, the column of the
    second haze index equal to its JVP at rtol 1e-10, exactly 6 launches
    of the fused kernel, the host reads; median time and peak memory of an
    evaluation in float64 and float32 (``SCAT_JACOBIAN_RUNS``), float32
    within 5e-4 of float64 and each float32 Jacobian column within
    ``JAC_F32_BOUND`` of its peak (the worst column of each model printed);
    the wall-clock of
    ``retrieval_nemesis(niter=3)`` on a copy of the deck;
18. the remaining models on the card ("models"): every model golden of
    the JAX package's model tests in float64 at their own tolerances
    (``model_golden_cases``: the profile, domain, spectral, exoplanet and
    Venus models on ``models_apply.npz``, ``models_domain.npz`` and
    ``models_exo_venus.npz``, ILS models 228-230 on ``ils_models.npz`` at
    5e-4 with a finite, nonzero ``jacfwd`` through 229, model 446 on an
    in-memory size lookup, 500 on the reference formula); the closed
    forms of the knee profile and of model 9 against their level loops
    (``knee_profile_loop``, ``model9_loop``) at rtol 1e-12, with the
    tensor operations of each form; then two
    composed copies of ``jupiter_nadir``: ``models_nadir``
    (``models_nadir_deck``: model 0 and nine fixture blocks, NX = 101) and
    ``models_ils`` (``models_ils_deck``: 350 channels, FWHM < 0, models 0,
    229 and 447, NX = 89), each in float64 against the port's CPU run of
    the same set-up (forward at rtol 1e-10, every column of the new models
    and three of model 0 within 1e-8 of their peaks), 6 primal launches a
    forward and 6 fused launches an evaluation, float32 against float64
    (spectrum within 1e-4, each Jacobian column within ``JAC_F32_BOUND``
    of its peak), the median time, peak
    memory and tensor operations of an evaluation beside those of the
    deck's own state vector; and the wall-clock of
    ``retrieval_nemesis(niter=3)`` on ``models_nadir``, whose phi must fall;
19. the geometries on the card ("geometries"): ``jupiter_limb`` as
    committed through ``make_retrieval_setup_limb`` (71 layers, 7 gases, 3
    tangent heights on 6 tangent paths of up to 126 layers, 303 channels,
    NX = 81) in float64 against ``jupiter_limb_fm.npz`` (rtol 2e-5) and
    against the port's CPU run (forward and the columns
    ``LIMB_JVP_COLUMNS`` at 1e-10), exactly 6 kernel-1 launches per
    forward and 6 kernel-1t launches per evaluation, float32 within 1e-4 /
    1e-5 of float64 and each float32 Jacobian column within
    ``JAC_F32_BOUND`` of its peak, the median time and peak memory of an
    evaluation in both types and the wall-clock of
    ``retrieval_nemesis(nemesis_l=True, niter=3)``; the disc set-up on
    ``jupiter_nadir`` at nmu = 3 against ``jupiter_disc_fm.npz`` (rtol
    1e-5), 6 launches of each kernel, the time and peak memory of an
    evaluation at nmu = 3 and 5; the combined set-up equal to the nadir
    set-up on ``jupiter_scatter`` (rtol 1e-10), and a copy at the three
    angles ``C_ANGLES`` equal to three single-angle copies;
20. nested sampling on the full ``jupiter_fdret`` ("nested"): the
    likelihood of 64 and 400 states vmapped in chunks of 64 against a loop
    of ``forward_fn`` (rtol 1e-10, 6 kernel-1 launches per chunk); the 3
    parameter posterior of the JAX package's slow
    ``tests/test_nested_deck.py`` against OE (means within 2 sigma, the
    best chi2 within 3x OE's); logZ, iterations, likelihoods, wall time and
    likelihoods per second;
21. solar occultation, AOTF, transit and the Titan FOV deck
    ("occultation"): the Mars SO deck read from its ``.npz`` export
    (``archnemesis_tpu_torch/data/mars_solocc.npz``: the card's machine
    has no h5py, and h5py must not be imported by the phase), the goldens
    ``mars_so_fm`` and ``mars_so_aotf_fm`` (rtol 1e-6, atol 1e-10),
    ``mars_transit_fm`` and ``titan_fov_fm`` (rtol 1e-5) in float64
    (``occultation_golden_cases``); the SO set-up on the export and the
    transit set-up on a copy of it made a transit run
    (``transit_deck_file``): the float64 forward against the port's CPU
    run (1e-10), float32 against float64 (spectrum within 1e-4, each
    Jacobian column within ``JAC_F32_BOUND`` of its peak), median time and
    peak memory of a forward-plus-Jacobian evaluation in both types; the
    wall-clock of ``retrieval_nemesis(nemesis_so=True, niter=3)`` on the
    export;
22. table generation on kernel 2 ("tablegen"): ``generate_lbltable``,
    ``generate_ktable`` and ``generate_ktable_chunked`` (1 and 3 chunks)
    against the reference's ``tests/fixtures/tablegen/co_ref.{lta,kta}``
    (rtol 3e-7; log k within 2e-3, chunked 2e-2); kernel 2 at the table
    shape (50,000 waves x 200 (P, T) columns) against its plain version
    (float64 at rtol 1e-10, float32 at phase 7's bound, float32 against
    float64 no further off than the plain float32 version plus that
    bound), its time beside its bound; then the production grid from the
    CO export (``TABLE_*``: 2000-2250 cm-1 at 0.005 cm-1, 20 pressures x 10
    temperatures; the k-table in 250 1 cm-1 bins, NG = 20, 4 chunks):
    wall time, launches (1 and 4), peak memory, the tables written and
    read back, kernel 2's share of the k-table's device time and its
    device time beside its bound summed over the chunks;
23. non-LTE emissions ("emissions"): the ``jupiter_emissions_fm`` golden
    in float64 at rtol 1e-5 (the golden deck with the C2H2 and NH3 tables
    read from their ``.npz`` exports, ``EMISS_EXPORTS``), 6 kernel-1
    launches per forward; float32 within phase 3's bounds (1e-4 / 1e-5) of
    float64; the jacfwd of the temperature and the two gases' VMR scales
    on the C2H2 band (``EMISS_JAC_WINDOW``) against the CPU (spectrum at
    rtol 1e-10, columns within 1e-10 of their peaks), 6 kernel-1t
    launches; the forward's and the 3-column evaluation's median time and
    peak memory with the tables and without them;
24. telluric transmission and multi-location forwards ("telluric,
    multiloc"): the telluric run (``TELLURIC_EXPORT``: jupiter_nadir with
    a Telluric group, models 0 and 202) through ``make_retrieval_setup(...,
    deck_file=)`` in float64 and float32, 7 launches of each kernel (the
    planet's 6 pairs and the telluric pair), float32 within 1e-4 / 1e-5 and
    each Jacobian column within ``JAC_F32_BOUND`` of its peak, the
    evaluation's time and peak memory; a copy thinned to its 600-700 cm-1
    channels (``thin_export``) against the CPU (spectrum at 1e-10, the
    columns of models 202 and 0 within 1e-10 of their peaks); then the
    headline at three locations (``multiloc_case``) through
    ``forward_nadir_multiloc``: 6 kernel-1 launches per forward for all
    locations, equal to three single forwards (float64 at 2e-12, float32
    at ``MULTILOC_F32_SELF``), float32 within 1e-4 / 1e-5 of float64, the
    times beside the three single forwards' and the peak memory; model
    1002's jacfwd of three per-location temperature scales (6 kernel-1t
    launches, time and peak memory), and at ``MULTILOC_CPU_NWAVE`` waves
    against the CPU (each column within 1e-10 of its peak); neither phase
    imports h5py;
25. database ingestion into kernel 2 ("ingestion"): a HITRAN ``.par``
    catalogue of 500,000 160-byte records from a seed (``ingest_par``:
    30,000 CO records of isotopes 1-3 at 1,900-2,300 cm-1, the rest other
    molecules at 500-12,000 cm-1, iso chars 0, A and B, Fortran fields
    without a leading zero) written to disk and decoded by the C++ and the
    numpy decoders, equal bit for bit, each with its MB/s; CO iso 1 through
    ``linelist_from_par`` (TIPS from the ``.npz`` export) onto phase 22's
    grid (2000-2250 cm-1 at 0.005 cm-1), through ``ops/lbl.
    lbl_cross_section(device="cuda")`` at the LBL headline's 40 layers in
    float32 and float64 (1 launch each): float64 within ``LBL_F64_RTOL`` of
    the plain version and float32 within ``LBL_F32_BOUNDS`` of it on
    ``LBL_COMPARE_LAYERS``, float32 within the bound of the plain float32
    version on all layers; the line counts, the median kernel time in both
    types beside ``lbl_bound_ms``, the peak memory; then a GEISA list
    (20,000 records through ``format_geisa_records``), an ExoMol list
    (5,000 states, 200,000 transitions, the ``.trans`` gzip'd) and an ans
    store's windowed fetch (``AnsDatabase`` on the CO export, its windowed
    and ``s_min`` fetches equal to the full read's slices), each through
    one float32 launch held to the plain version at the same bounds; and
    the profiling module around phase 3's golden-deck forward:
    ``stopwatch`` at least the forward's CUDA-event time, ``trace()`` into
    ``build/ingest_trace`` holding its ``annotate`` region and kernel 1's
    6 launches, ``device_memory_report()``'s ``cuda:0`` peak at least
    ``max_memory_allocated``; the phase imports neither h5py nor
    matplotlib;
26. line-by-line at run time through the tangent set-ups ("lbl
    geometries"): the three ILBL = 1 decks of ``lbl_tangent_deck`` (limb:
    3 tangent heights, FWHM = 0; SO: 5 tangent heights, a Gaussian ILS and
    a Doppler shift; transit: IFORM = TransitDepth, the stellar radius from
    an inline ``.sol``; line data from the ``.npz`` export, NX = 30:
    temperature and CO) through ``make_retrieval_setup_limb``, ``_so`` and
    ``_transit`` in float64 and float32: exactly 1 kernel-2 launch per
    forward and per forward-plus-Jacobian evaluation, none of kernels 1 and
    1t; float64 against the port's CPU run (forward at rtol 1e-10, every
    Jacobian column within 1e-10 of its peak), float32 within
    ``LBL_F32_BOUNDS`` and each float32 Jacobian column within
    ``JAC_F32_BOUND`` of its peak; the median time and peak memory of an
    evaluation in each type with the share of kernel 2's plain-version
    tangent (``plain_tangent_ms``); the wall-clock of
    ``retrieval_nemesis(nemesis_so=True, niter=3)``, whose phi must fall;
    then the LBL headline through ``forward_so`` and ``forward_limb_batch``
    over 15 tangent heights and ``forward_transit`` over every layer base:
    1 launch per forward and no packing after the first, the median of 12
    forwards, waves/s and peak memory, and float32 against the float64
    forward of the same call (``lbl_geometry_f32_errors``: the radiative
    transfer on the float64 optical depths and the synthesis on phase 7's
    layers within ``LBL_F32_BOUNDS``, the transit depth end to end too; the
    limb and SO spectra end to end printed beside them); the phase imports
    no h5py;
27. the correlated-k Jacobian's tangent passes ("tangent passes",
    ``csrc/tangent_ops.cu``): one forward-plus-Jacobian evaluation of the
    headline deck in float32 through ``forward_and_jacobian`` (NX = 86:
    the 81 level temperatures and a scale of each of gases 2-6, the
    benchmark's ``jupiter_ck_oe`` state), with both kernels' launch
    counters reset first: 7 launches of ``gas_tau_tangent`` (one a gas), 6
    of ``skip_rows_`` and 6 of kernel 1t (one a combine), K (8192, 86)
    finite, its median time and peak memory; then each kernel on card
    tensors at that evaluation's shapes against its plain version on the
    same tensors (``gas_tau_tangent_plain``, ``skip_rows_plain``):
    ``gas_tau_tangent`` at (8192, 71, 20) x 86 tangents in float32 and
    float64, and at 2 states x 16 tangents, each element within 4 eps of
    the sum of its three terms' magnitudes; ``skip_rows_`` at R =
    581,632, NG = 20, T = 86 with a seventh of the rows skipped for a and
    a fifth for b, bit for bit; each timed beside its plain version and
    its bound (``gas_tau_tangent_bound_ms``, ``skip_rows_bound_ms``); the
    evaluation makes 1 launch of ``emission_tangent`` too, which then runs
    at the cell's width (``emission_tangent_case``: T = 86, 8192 waves x
    20 g x 71 layers, the tangent as the random overlap lays it out) in
    float32 against the plain version in float64 (each tangent within
    ``EMISSION_F32_REL`` of its peak, the plain version in float32 printed
    beside it), timed beside the plain version in float32 and its bound
    (``emission_tangent_bound_ms``); phases 6, 18, 19 and 24 count 1
    launch an evaluation of jupiter_nadir, models_nadir, the limb and
    model 1002, and print the disc's;
28. the layering and path as CUDA graphs ("layer graph",
    ``rt/layer_graph.py``): at the layouts of both forward cells of the
    benchmark (``synthetic.headline_deck``'s and ``lbl_headline``'s
    atmospheres), float32, ``LAYER_GRAPH_RUNS`` consecutive states, each
    laid out eagerly and by replay: the host ms (launching) and the stream
    ms (CUDA events) of each, medians, with the replay's layers and path
    equal to the eager ones bit for bit on every state, every graphed call
    a replay and at most one capture (phase 4 lays out the same
    atmosphere; the first graphed call's wall ms printed); then the
    headline's ``forward_nadir`` over ``LAYER_GRAPH_GEOMETRIES`` twice: at
    most one capture, every forward a replay, its diagnostics' layers and
    path the eager ones at its angles bit for bit. ``python3 -c "import
    chip_smoke; chip_smoke.phase_layer_graph()"`` runs it alone;

then a JSON line of the kernels (launches on the main paths, error, times,
bound, library time) and, last, ``{"ok": true, "device": {...}}``. ``--profile`` adds
``torch.profiler`` traces of three headline forwards, of one
forward-plus-Jacobian evaluation, of three LBL headline forwards, of one
scattering headline forward, of one scattering forward-plus-Jacobian
evaluation and of three of each full-width tangent forward of phase 26: device time by kernel, the device's busy share, and Chrome
traces in ``build/``.

TF32 is switched off for matmuls and cuDNN: the g-quadrature and emission
``einsum``s must run in full float32, as the JAX package computes them.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from nembench.harness import bounds as bench_bounds
from nembench.harness import tangent_bounds
from nembench.harness.bounds import (
    PEAK_BYTES_S,
    PEAK_F32_OPS_S,
    PEAK_F64_OPS_S,
    combine_ops_per_row,
)
from nembench.harness.tangent_bounds import tangent_ops_per_row

LAYER_GOLDEN = "tests/goldens/jupiter_layering.npz"
FM_GOLDEN = "tests/goldens/jupiter_nadir_fm.npz"
DECK = "tests/fixtures/jupiter_nadir"
FDRET = "tests/fixtures/jupiter_fdret"
OE_GOLDEN = "tests/goldens/jupiter_oe.npz"
FD_GOLDEN = "tests/goldens/jupiter_fd_jac.npz"
RETRIEVAL_GOLDEN = "tests/goldens/jupiter_retrieval.npz"
CIA_TAB = "archnemesis_tpu/data/reference_data/cia/isotest.tab"
# the runtime line-by-line slice: the CO line list's export (the card's
# machine has no h5py), the reference's cross-sections and the runtime deck
LINEDATA_NPZ = "archnemesis_tpu_torch/data/CO_1_ambient_AIR.npz"
CO_LBL_GOLDEN = "tests/goldens/co_lbl.npz"
CO_RUNTIME = "tests/fixtures/co_runtime"
CO_RUNTIME_GOLDEN = "tests/goldens/co_runtime_fm.npz"

F32_BOUNDS = (1.0e-4, 1.0e-5)  # max / median relative error vs float64
# largest float32-vs-float64 error of the Jacobian relative to each
# column's own peak. The first run on the card read 4.8e-4 on jupiter_nadir:
# the worst columns are those of the levels far above and below the
# weighting functions, whose peaks lie up to 12 orders under the largest
# and rest on layers with tau ~ 1e-9 (before rt/emission.py formed the
# transmission differences with expm1 they were lost altogether in
# float32: error 1.3 of peak). Twice the reading, and the loosest allowed.
# Since the path geometry stopped subtracting numbers of the planet's size
# (rt/layer.py:ray_length) the CPU reads 1.0e-5 there.
JAC_F32_BOUND = 1.0e-3
HEADLINE_RUNS = 12
JACOBIAN_RUNS = 5
# float32 line-by-line synthesis against float64: max / median relative
# error, the JAX package's own co_runtime_voigt bound
# (tests/test_f32_parity.py:23)
LBL_F32_BOUNDS = (5.0e-5, 2.0e-5)
# float64 kernel against the plain version and the reference golden (the
# JAX package's Pallas-vs-XLA bound, tests/test_lbl_pallas.py:38)
LBL_F64_RTOL = 1.0e-10
LBL_KERNEL_RUNS = 10
# the layers of the full-width configuration on which the float64 plain
# version (3.3 GB per (block, line, wave) temporary) is compared
LBL_COMPARE_LAYERS = (0, 39)
# the retrieval's pair combine: 559 waves x 71 layers, 81 state elements
TAN_ROWS, TAN_NTAN = 39_689, 81


def rel_err(a, b):
    """|a - b| / max(|b|, 1e-3 max|b|), elementwise (0 where b is all
    zero and a equals it)."""
    scale = max(1e-3 * np.abs(b).max(), np.finfo(np.float64).tiny)
    return np.abs(a - b) / np.maximum(np.abs(b), scale)


def gauss_del_g(ng: int) -> np.ndarray:
    """Gauss-Legendre g-bin widths on [0, 1]."""
    return 0.5 * np.polynomial.legendre.leggauss(ng)[1]


def overlap_inputs(rows: int, ng: int, seed: int) -> tuple:
    """Two (rows, NG) float64 arrays of sorted k-distributions with tied
    and all-zero rows (as the JAX package's Pallas tests make them)."""
    rng = np.random.default_rng(seed)
    ta = np.sort(rng.uniform(0, 4, (rows, ng)), axis=1)
    tb = np.sort(rng.uniform(0, 2, (rows, ng)), axis=1)
    ta[:10] = 0.0
    tb[5:15] = 0.0
    return ta, tb


def tiefree_overlap_inputs(rows: int, ng: int, seed: int) -> tuple:
    """Two (rows, NG) float64 arrays, sorted along g, whose NG*NG pair sums
    are distinct integers times 2**-16: no two keys tie or come close in
    float32 or in float64, so every sort puts them in one order. a = M *
    (distinct integers), b = distinct integers below M."""
    rng = np.random.default_rng(seed)
    m = 64
    a = np.sort(rng.permuted(np.tile(np.arange(4096), (rows, 1)),
                             axis=1)[:, :ng], axis=1) * float(m)
    b = np.sort(rng.permuted(np.tile(np.arange(m), (rows, 1)),
                             axis=1)[:, :ng], axis=1).astype(np.float64)
    return a * 2.0**-16, b * 2.0**-16


# rows of the hard cases of phase 2: odd, so that no block of a
# power-of-two number of rows divides them and the last block is ragged
HARD_ROWS = 4099
HARD_NGS = (1, 2, 3, 7, 20, 31, 32)


def combine_cases(rows: int, ng: int, seed: int) -> dict:
    """name -> two (rows, NG) float64 arrays: ``sorted`` (``overlap_inputs``,
    with tied and all-zero rows), ``unsorted_a`` / ``unsorted_b`` /
    ``unsorted_both`` (those rows shuffled along g), ``ties`` (half the rows
    one repeated value, the rest small integers times 1/4, so that the pair
    sums are exact and tie everywhere) and ``zeros``."""
    rng = np.random.default_rng(seed)
    ta, tb = overlap_inputs(rows, ng, seed)
    sa, sb = rng.permuted(ta, axis=1), rng.permuted(tb, axis=1)
    ties_a = np.sort(rng.integers(0, 4, (rows, ng)), axis=1) * 0.25
    ties_b = np.sort(rng.integers(0, 3, (rows, ng)), axis=1) * 0.25
    half = rows // 2
    ties_a[:half] = rng.uniform(0, 4, (half, 1))
    ties_b[:half] = rng.uniform(0, 2, (half, 1))
    return {
        "sorted": (ta, tb),
        "unsorted_a": (sa, tb),
        "unsorted_b": (ta, sb),
        "unsorted_both": (sa, sb),
        "ties": (ties_a, ties_b),
        "zeros": (np.zeros((rows, ng)), np.zeros((rows, ng))),
    }


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length()


def combine_bound_ms(rows: int, ng: int, itemsize: int,
                     presorted: bool) -> tuple:
    """(bound_ms, bound_by) of one combine on an H100
    (``nembench.harness.bounds.combine_bound_ms``)."""
    ms = bench_bounds.combine_bound_ms(rows, ng, itemsize, presorted)
    ops_ms = rows * combine_ops_per_row(ng, presorted) / PEAK_F32_OPS_S * 1e3
    return ms, ("operations" if ms == ops_ms else "bytes")


def tangent_f32_tol(del_g) -> float:
    """float32 bound of a rebinned tangent, relative to the tangents' peak:
    phase 2's 2e-5, or where that is larger the rounding of an overlap's two
    prefix sums near 1 (eps32 each) against the narrowest bin (6.8e-5 at
    NG=32, where the card's first run read 2.2e-5)."""
    return max(2e-5, 2 * float(np.finfo(np.float32).eps) / float(min(del_g)))


def fused_bound_ms(rows: int, ng: int, n_tan: int, itemsize: int,
                   presorted: bool) -> tuple:
    """(bound_ms, bound_by) of one fused primal + tangent combine on an
    H100 (``nembench.harness.tangent_bounds.fused_combine_bound_ms``)."""
    ms = tangent_bounds.fused_combine_bound_ms(rows, ng, n_tan, itemsize,
                                               presorted)
    bytes_ms = (tangent_bounds.fused_combine_bytes(rows, ng, n_tan, itemsize)
                / PEAK_BYTES_S * 1e3)
    return ms, ("bytes" if ms == bytes_ms else "operations")


def is_sorted_along_g(*taus) -> bool:
    """Whether every row of every (R, NG) tensor is non-decreasing."""
    return all(bool((t.diff(dim=1) >= 0).all()) for t in taus)


def golden_deck(device):
    """The jupiter_nadir deck as ``tests/test_forward_nadir.py`` sets it up,
    read with the port's readers: (atm, laycfg, ktab, cia, aero, surf, cfg)
    in float64 on ``device``."""
    import torch

    from archnemesis_tpu_torch.core.spectra import (
        AerosolOptics,
        KTables,
        SurfaceSpec,
    )
    from archnemesis_tpu_torch.core.types import Atmosphere, LayerConfig
    from archnemesis_tpu_torch.enums import (
        ParaH2Ratio,
        RayleighScatteringMode,
        WaveUnit,
    )
    from archnemesis_tpu_torch.forward import make_forward_config
    from archnemesis_tpu_torch.io.cia import read_cia_tab
    from archnemesis_tpu_torch.io.ktables import read_kls

    dl = np.load(LAYER_GOLDEN)
    wave = np.load(FM_GOLDEN)["WAVE"]

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                               device=device)

    atm = Atmosphere(
        h=dev(dl["H"]), p=dev(dl["P"]), t=dev(dl["T"]), vmr=dev(dl["VMR"]),
        dust=dev(dl["DUST"]), parah2=dev(dl["PARAH2"]),
        molwt=dev(dl["MOLWT"]), radius=dev(dl["RADIUS"]),
        latitude=dev(dl["LATITUDE"]),
        gas_id=tuple(int(x) for x in dl["ID"]),
        iso_id=tuple(int(x) for x in dl["ISO"]),
        planet=int(dl["PLANET"]),
        dust_units_flag=tuple(int(x) for x in dl["DUST_UNITS_FLAG"]) or None,
    )
    laycfg = LayerConfig(
        nlay=int(dl["NLAY"]), laytyp=int(dl["LAYTYP"]),
        layint=int(dl["LAYINT"]),
        layht=max(float(dl["LAYHT"]), float(dl["H"][0])),
    )
    tables = read_kls(f"{DECK}/cirstest.kls", wavemin=wave.min(),
                      wavemax=wave.max())
    ktab = KTables.from_tables(tables, device=device)
    cia = read_cia_tab(CIA_TAB, dnu=1.0, npara=0,
                       inormal=ParaH2Ratio.NORMAL, device=device)
    # deck .xsc: 6 wave points, all-zero extinction
    aero = AerosolOptics(
        wave=dev([0.0, 700.0, 750.0, 900.0, 950.0, 2000.0]),
        kext=dev(np.zeros((6, 1))), ksca=dev(np.zeros((6, 1))),
    )
    surf = SurfaceSpec(tsurf=dev(0.0), vem=dev([0.0, 1e5]),
                       emissivity=dev(np.zeros(2)), galb=dev(0.0),
                       gasgiant=True)
    cfg = make_forward_config(
        atm, ktab, cia, iray=RayleighScatteringMode.GAS_GIANT_ATM,
        ispace=WaveUnit.Wavenumber_cm, gasgiant=True,
    )
    return atm, laycfg, ktab, cia, aero, surf, cfg


def cast(deck, dtype):
    """``cast_deck`` over the structures of a deck tuple (the float32 path
    prescales CIA and attaches the host log k-table)."""
    from archnemesis_tpu_torch.core.spectra import cast_deck

    atm, laycfg, ktab, cia, aero, surf, cfg = deck
    return (cast_deck(atm, dtype), laycfg, cast_deck(ktab, dtype),
            cast_deck(cia, dtype), cast_deck(aero, dtype),
            cast_deck(surf, dtype), cfg)


def deck_forward(deck, device):
    """(spectrum (NWAVE,), SPECONV (NCONV,), diagnostics) of the deck."""
    from archnemesis_tpu_torch.forward import forward_nadir
    from archnemesis_tpu_torch.ops.convolution import conv_channel_interp

    dfm = np.load(FM_GOLDEN)
    atm, laycfg, ktab, cia, aero, surf, cfg = deck
    spec, diag = forward_nadir(atm, laycfg, ktab, cia, aero, surf, cfg,
                               emiss_ang=0.0, sol_ang=180.0,
                               return_diagnostics=True, device=device)
    nconv = int(dfm["NCONV"][0])
    vconv = np.asarray(dfm["VCONV"][:nconv, 0])
    speconv = conv_channel_interp(ktab.wave, spec[:, 0],
                                  spec.new_tensor(vconv))
    return spec[:, 0], speconv, diag


def _print(*args):
    print(*args, flush=True)


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` calls (CUDA
    events), after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    """The card and the versions; every kernel library built from the
    checkout's sources, one nvcc per source, and the host fixed-width
    decoder (``native/src/fixed_width.cpp``, g++), all started together."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from archnemesis_tpu_torch import native
    from archnemesis_tpu_torch.ops import (
        fma_peak,
        lbl_cuda,
        overlap_cuda,
        overlap_variants,
        tangent_cuda,
    )
    from archnemesis_tpu_torch.tools.common import card_line

    card = card_line()
    _print(f"card: {card}")
    _print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    modules = (overlap_cuda, lbl_cuda, overlap_variants, fma_peak,
               tangent_cuda)
    with ThreadPoolExecutor(max_workers=len(modules) + 1) as pool:
        futures = [pool.submit(m.build) for m in modules]
        decoder = pool.submit(native.build)
        builds = [f.result() for f in futures]
        decoder = decoder.result()
    for built in builds:
        _print(f"built {built['path']} in {built['seconds']:.2f} s")
        _print(built["ptxas"].strip())
    _print(f"built the fixed-width decoder {decoder['path']} in "
           f"{decoder['seconds']:.2f} s with {decoder['compiler']}")
    _print(f"kernel builds: {time.perf_counter() - t0:.2f} s of wall time")
    return card


def _check_combine(out, a, b, del_g, what: str) -> float:
    """Hold one kernel result to the plain version at phase 2's bounds;
    returns the max abs error against the plain version of its type."""
    import torch

    from archnemesis_tpu_torch.ops.overlap_cuda import combine_pair_plain

    tols = {torch.float32: dict(rtol=2e-5, atol=1e-7),
            torch.float64: dict(rtol=1e-12, atol=0.0)}
    ng, dtype = a.shape[1], a.dtype
    ref = combine_pair_plain(a, b, del_g)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    line = f"kernel vs plain {what}: max_abs_err={err:.3e}"
    # the float32 bound holds two float32 versions to each other up to
    # NG=20; at NG=32 the plain version's own rounding error comes near
    # it, so there the float32 kernel is held to the float64 result
    # only. Every float32 kernel result is held to it as well.
    checks = []
    if dtype == torch.float64 or ng <= 20:
        checks.append(torch.allclose(out, ref, **tols[dtype]))
    if dtype == torch.float32:
        ref64 = combine_pair_plain(a.double(), b.double(), del_g)
        checks.append(torch.allclose(out.double(), ref64, **tols[dtype]))
        k64 = rel_err(out.double().cpu().numpy(), ref64.cpu().numpy())
        p64 = rel_err(ref.double().cpu().numpy(), ref64.cpu().numpy())
        line += (f"; vs float64: kernel max rel {k64.max():.3e}, plain"
                 f" max rel {p64.max():.3e}")
    ok = all(checks) and bool(torch.isfinite(out).all())
    _print(f"{line} ({'ok' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"kernel disagrees with plain ({what})")
    return err


# further shapes phase 2 times kernel 1 at: the scattering headline's, and
# the headline's in float64
COMBINE_TIMED = ((79_872, 10, "float32"), (581_632, 20, "float64"))


def _time_combine(rows: int, ng: int, dtype: str):
    """Kernel 1's and the plain version's device ms on ``overlap_inputs`` of
    one shape, beside the bound; the kernel held to the plain version."""
    import torch

    from archnemesis_tpu_torch.ops.overlap_cuda import (
        combine_pair,
        combine_pair_plain,
    )

    del_g = gauss_del_g(ng)
    ta, tb = overlap_inputs(rows, ng, seed=ng + rows)
    a = torch.as_tensor(ta, dtype=getattr(torch, dtype), device="cuda")
    b = torch.as_tensor(tb, dtype=getattr(torch, dtype), device="cuda")
    _check_combine(combine_pair(a, b, del_g), a, b, del_g,
                   f"NG={ng} {dtype} rows={rows}")
    ms = _cuda_ms(lambda: combine_pair(a, b, del_g), reps=20)
    plain_ms = _cuda_ms(lambda: combine_pair_plain(a, b, del_g), reps=2,
                        warmup=1)
    bound_ms, bound_by = combine_bound_ms(rows, ng, a.element_size(),
                                          is_sorted_along_g(a, b))
    _print(f"combine at R={rows}, NG={ng}, {dtype}: kernel {ms:.4f} ms, "
           f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")


def phase_kernel_vs_plain():
    """Kernel vs plain on the card; returns the headline-shape record."""
    import torch

    from archnemesis_tpu_torch.ops.overlap_cuda import (
        combine_pair,
        combine_pair_plain,
    )

    cases = [(ng, dt, 4096) for ng in (10, 20, 32)
             for dt in (torch.float32, torch.float64)]
    rows_full = 581_632
    cases.append((20, torch.float32, rows_full))
    record = None
    for ng, dtype, rows in cases:
        del_g = gauss_del_g(ng)
        ta, tb = overlap_inputs(rows, ng, seed=ng + rows)
        a = torch.as_tensor(ta, dtype=dtype, device="cuda")
        b = torch.as_tensor(tb, dtype=dtype, device="cuda")
        out = combine_pair(a, b, del_g)
        err = _check_combine(out, a, b, del_g, f"NG={ng} {dtype} rows={rows}")
        if rows == rows_full:
            # no atomics: a second launch on the same input gives the same
            # bits
            again = combine_pair(a, b, del_g)
            if not torch.equal(out, again):
                raise AssertionError("two launches differ at full size")
            _print("two launches at full size: equal bits")
            ms = _cuda_ms(lambda: combine_pair(a, b, del_g), reps=20)
            plain_ms = _cuda_ms(lambda: combine_pair_plain(a, b, del_g),
                                reps=3, warmup=1)
            presorted = is_sorted_along_g(a, b)
            bound_ms, bound_by = combine_bound_ms(rows, ng, a.element_size(),
                                                  presorted)
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
            _print(f"combine at R={rows}, NG={ng}, float32: kernel "
                   f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                   f"{bound_ms:.4f} ms ({bound_by}; "
                   f"{combine_ops_per_row(ng, presorted)} ops/row, inputs "
                   f"{'' if presorted else 'not '}sorted along g)")
    for rows, ng, dtype in COMBINE_TIMED:
        _time_combine(rows, ng, dtype)

    # rows unsorted along g, heavy ties, all-zero rows, every NG class, a
    # ragged last block
    for ng in HARD_NGS:
        del_g = gauss_del_g(ng)
        for name, (ta, tb) in combine_cases(HARD_ROWS, ng, seed=ng).items():
            for dtype in (torch.float32, torch.float64):
                a = torch.as_tensor(ta, dtype=dtype, device="cuda")
                b = torch.as_tensor(tb, dtype=dtype, device="cuda")
                _check_combine(combine_pair(a, b, del_g), a, b, del_g,
                               f"NG={ng} {dtype} {name} rows={HARD_ROWS}")
    return record


def phase_golden_deck():
    import torch

    dfm = np.load(FM_GOLDEN)
    deck64 = golden_deck("cuda")
    spec64, conv64, diag = deck_forward(deck64, "cuda")
    for name, key in (("taugas", "TAUGAS"), ("taucia", "TAUCIA"),
                      ("tauray", "TAURAY"), ("taudust", "TAUDUST"),
                      ("tautot", "TAUTOT")):
        want = dfm[key]
        atol = 1e-14 * max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(diag[name].cpu().numpy(), want,
                                   rtol=1e-5, atol=atol, err_msg=name)
    nconv = int(dfm["NCONV"][0])
    np.testing.assert_allclose(conv64.cpu().numpy(),
                               dfm["SPECONV"][:nconv, 0], rtol=1e-5, atol=0)
    _print("golden deck float64: layer taus and SPECONV within rtol 1e-5")

    _, conv32, _ = deck_forward(cast(deck64, torch.float32), "cuda")
    r = rel_err(conv32.double().cpu().numpy(), conv64.cpu().numpy())
    _print(f"golden deck float32 vs float64: max rel {r.max():.3e}, "
           f"median rel {np.median(r):.3e}")
    if not (r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1]):
        raise AssertionError("float32 deck outside 1e-4 / 1e-5 of float64")


def profile_forward(forward, runs: int = 3, what: str = "headline forward",
                    trace: str = "build/headline_trace.json"):
    """Device time by kernel and the device's busy share over ``runs``
    calls of ``forward`` (``torch.profiler``); the trace goes to
    ``build/``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            forward()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the program's spans (``profiling.annotate``) are ranges, not kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    _print(f"profile of {runs} x {what}: wall {wall_us / 1e3:.3f} "
           f"ms, device busy {busy_us / 1e3:.3f} ms "
           f"(share {busy_us / wall_us:.4f}), "
           f"{sum(e.count for e in kernels) // runs} launches each")
    for e in kernels[:15]:
        _print(f"  {e.self_device_time_total / runs / 1e3:9.4f} ms/call "
               f"{e.count // runs:5d} launches/call  {e.key[:100]}")
    combine = [e for e in kernels if "combine_" in e.key]
    if combine:
        _print(f"  random-overlap kernels (1, 1t): "
               f"{sum(e.self_device_time_total for e in combine) / runs / 1e3:.4f}"
               f" ms/call, {sum(e.count for e in combine) // runs} "
               "launches/call")
    os.makedirs("build", exist_ok=True)
    prof.export_chrome_trace(trace)


def kernel_device_ms(fn, runs: int = 5) -> dict:
    """Device time per call of ``fn`` by kernel name, in ms, over ``runs``
    calls (``torch.profiler``, CUDA activity only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / runs / 1e3
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def phase_headline(profile: bool = False):
    """Drive the headline forward; returns (launches of the main path,
    median ms)."""
    import torch

    from archnemesis_tpu_torch.forward import forward_nadir
    from archnemesis_tpu_torch.ops.overlap_cuda import combine_pair
    from archnemesis_tpu_torch.synthetic import NWAVE, headline_deck

    atm, laycfg, ktab, surf, cfg = headline_deck(dtype=torch.float32,
                                                 device="cuda")

    def forward():
        return forward_nadir(atm, laycfg, ktab, None, None, surf, cfg,
                             emiss_ang=0.0, device="cuda")

    # the main path, counted on its own
    combine_pair.launches = 0
    spec = forward()
    torch.cuda.synchronize()
    launches = combine_pair.launches
    if launches != 6:
        raise AssertionError(f"{launches} kernel launches, expected 6")
    if spec.shape != (NWAVE, 1) or not torch.isfinite(spec).all():
        raise AssertionError("headline spectrum not finite (8192, 1)")

    torch.cuda.reset_peak_memory_stats()
    times = []
    before = combine_pair.launches
    for i in range(HEADLINE_RUNS + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        forward()
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    if combine_pair.launches - before != 6 * (HEADLINE_RUNS + 2):
        raise AssertionError("kernel launches did not rise by 6 per forward")
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(times))
    _print(f"headline forward (8192 x 20 x 71 x 7 gases, float32): median "
           f"{ms:.3f} ms over {len(times)} runs (min {min(times):.3f}, "
           f"max {max(times):.3f}); {NWAVE / ms * 1e3:.1f} waves/s; peak "
           f"memory {peak / 2**30:.3f} GiB")

    atm64, laycfg, ktab64, surf64, cfg = headline_deck(dtype=torch.float64,
                                                       device="cuda")
    spec64 = forward_nadir(atm64, laycfg, ktab64, None, None, surf64, cfg,
                           emiss_ang=0.0, device="cuda")
    r = rel_err(spec.double().cpu().numpy(), spec64.cpu().numpy())
    _print(f"headline float32 vs float64: max rel {r.max():.3e}, "
           f"median rel {np.median(r):.3e}")
    if not (r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1]):
        raise AssertionError("float32 headline outside 1e-4 / 1e-5 of float64")
    if profile:
        profile_forward(forward)
    return launches, ms


def graph_replay_equal(fn) -> bool:
    """Whether one call of ``fn`` (a tuple of tensors out) captured in a
    ``torch.cuda.CUDAGraph`` and replayed gives the direct call's bits."""
    import torch

    direct = fn()
    side = torch.cuda.Stream()  # warm-up off the capturing stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(direct, captured))
    del graph, captured
    return same


def phase_tangent_kernel_vs_plain():
    """Fused primal + tangent kernel vs plain on the card; returns the
    float32 record at the retrieval's shape."""
    import torch

    from archnemesis_tpu_torch.ops.overlap_cuda import (
        combine_pair,
        combine_pair_with_tangents,
        combine_pair_with_tangents_plain,
    )

    def on_card(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device="cuda")

    def check(ta, tb, dta, dtb, del_g, what, vs_plain32=True,
              time_it=False):
        """The fused kernel on tie-free rows in both types: dout against
        the plain float64 result (and, with ``vs_plain32``, the plain
        float32 one up to NG = 20), out equal to the primal kernel's bit for
        bit. Returns the float32 record when ``time_it``."""
        ng = ta.shape[1]
        a64, b64, da64, db64 = (on_card(x, torch.float64)
                                for x in (ta, tb, dta, dtb))
        _, ref64 = combine_pair_with_tangents_plain(a64, b64, da64, db64,
                                                    del_g)
        peak = ref64.abs().max().item()
        record = None
        for dtype in (torch.float64, torch.float32):
            a, b, da, db = (x.to(dtype) for x in (a64, b64, da64, db64))
            out, dout = combine_pair_with_tangents(a, b, da, db, del_g)
            torch.cuda.synchronize()
            # the inputs are exact in float32, so ref64 is the float64
            # result of the same inputs for both types
            err = (dout.double() - ref64).abs().max().item()
            tol = 1e-12 if dtype == torch.float64 else tangent_f32_tol(del_g)
            checks = [err <= tol * peak,
                      torch.equal(out, combine_pair(a, b, del_g))]
            line = (f"tangent kernel vs plain {what} {dtype}: "
                    f"max_abs_err={err:.3e} (peak {peak:.3e}); primal equal "
                    f"to kernel 1's: {checks[1]}")
            if dtype == torch.float32:
                _, ref32 = combine_pair_with_tangents_plain(a, b, da, db,
                                                            del_g)
                e32 = (dout - ref32).abs().max().item()
                p32 = (ref32.double() - ref64).abs().max().item()
                if vs_plain32 and ng <= 20:
                    checks.append(e32 <= tol * peak)
                line += (f"; vs float32 plain {e32:.3e} (plain float32 vs "
                         f"float64 {p32:.3e})")
            ok = all(checks)
            _print(f"{line} ({'ok' if ok else 'FAIL'})")
            if not ok:
                raise AssertionError(f"tangent kernel disagrees ({what}, "
                                     f"{dtype})")
            if not time_it:
                continue
            # no atomics: a second launch, and one replayed from a CUDA
            # graph, give the same bits
            again = combine_pair_with_tangents(a, b, da, db, del_g)
            if not (torch.equal(out, again[0])
                    and torch.equal(dout, again[1])):
                raise AssertionError(f"two fused launches differ ({dtype})")
            del again
            if not graph_replay_equal(lambda: combine_pair_with_tangents(
                    a, b, da, db, del_g)):
                raise AssertionError(f"CUDA-graph replay differs ({dtype})")
            _print(f"fused combine {what} {dtype}: two launches and a "
                   "CUDA-graph replay give equal bits")
            n_tan, rows = da.shape[:2]
            ms = _cuda_ms(lambda: combine_pair_with_tangents(
                a, b, da, db, del_g), reps=10)
            plain_ms = _cuda_ms(lambda: combine_pair_with_tangents_plain(
                a, b, da, db, del_g), reps=2, warmup=1)
            presorted = is_sorted_along_g(a, b)
            bound_ms, bound_by = fused_bound_ms(rows, ng, n_tan,
                                                a.element_size(), presorted)
            _print(f"fused combine at T={n_tan}, R={rows}, NG={ng}, {dtype}: "
                   f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                   f"{bound_ms:.4f} ms ({bound_by}; "
                   f"{tangent_ops_per_row(ng)} ops/row/tangent)")
            # the launch without tangents (phase A: the merge, the
            # matrices and out) beside kernel 1; the rest is phase B's
            none = da[:0]
            merge_ms = _cuda_ms(lambda: combine_pair_with_tangents(
                a, b, none, none, del_g), reps=10)
            kernel1_ms = _cuda_ms(lambda: combine_pair(a, b, del_g), reps=10)
            tan_bytes_ms = (3 * n_tan * rows * ng * a.element_size()
                            / PEAK_BYTES_S * 1e3)
            _print(f"fused combine phases, {dtype}: T=0 {merge_ms:.4f} ms "
                   f"(kernel 1 alone {kernel1_ms:.4f} ms); T={n_tan} less "
                   f"T=0 {ms - merge_ms:.4f} ms against {tan_bytes_ms:.4f} "
                   "ms for the tangents' bytes")
            if dtype == torch.float32:
                record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        return record

    cases = [(ng, t, 4096) for ng in (10, 20, 32) for t in (1, 3, TAN_NTAN)]
    cases.append((20, TAN_NTAN, TAN_ROWS))
    record = None
    for ng, n_tan, rows in cases:
        ta, tb = tiefree_overlap_inputs(rows, ng, seed=ng + n_tan)
        rng = np.random.default_rng(rows + n_tan)
        dta = rng.standard_normal((n_tan, rows, ng))
        dtb = rng.standard_normal((n_tan, rows, ng))
        got = check(ta, tb, dta, dtb, gauss_del_g(ng),
                    f"NG={ng} T={n_tan} rows={rows}",
                    time_it=rows == TAN_ROWS)
        record = got or record

    # tied and all-zero rows: the primal bit for bit; the tangents depend
    # on the order of equal keys and need only be finite
    for ng in (10, 20, 32):
        del_g = gauss_del_g(ng)
        ta, tb = overlap_inputs(4096, ng, seed=ng)
        rng = np.random.default_rng(ng)
        for dtype in (torch.float32, torch.float64):
            a, b = on_card(ta, dtype), on_card(tb, dtype)
            da = on_card(rng.standard_normal((3, 4096, ng)), dtype)
            out, dout = combine_pair_with_tangents(a, b, da, da, del_g)
            if not (torch.equal(out, combine_pair(a, b, del_g))
                    and torch.isfinite(dout).all()):
                raise AssertionError(f"tied rows fail ({ng}, {dtype})")
    _print("tied and all-zero rows: fused primal equal to kernel 1's bit "
           "for bit, tangents finite")

    # the hard rows of phase 2 (a ragged last block, rows unsorted along g,
    # heavy ties, all-zero rows) at every NG class: the primal bit for bit,
    # the tangents finite (on tied keys they depend on the order of equal
    # keys); and tie-free rows shuffled along g, whose tangents are held to
    # the plain float64 version. Not to the plain float32 one: on these
    # rows its serial cumsum of the NG^2 weights strays further from
    # float64 than the kernel's scan (at NG = 20, unsorted_both, the card's
    # first run read the kernel 1.83e-4 from the plain float32 version and
    # 5.6e-5 from float64, against a bound of 1.27e-4)
    for ng in HARD_NGS:
        del_g = gauss_del_g(ng)
        rng = np.random.default_rng(ng)
        dta = rng.standard_normal((3, HARD_ROWS, ng))
        dtb = rng.standard_normal((3, HARD_ROWS, ng))
        for name, (ta, tb) in combine_cases(HARD_ROWS, ng, seed=ng).items():
            for dtype in (torch.float32, torch.float64):
                a, b, da, db = (on_card(x, dtype) for x in (ta, tb, dta, dtb))
                out, dout = combine_pair_with_tangents(a, b, da, db, del_g)
                if not (torch.equal(out, combine_pair(a, b, del_g))
                        and torch.isfinite(dout).all()):
                    raise AssertionError(
                        f"fused kernel on hard rows fails (NG={ng} {name} "
                        f"{dtype})")
        ta, tb = tiefree_overlap_inputs(HARD_ROWS, ng, seed=ng)
        sa, sb = rng.permuted(ta, axis=1), rng.permuted(tb, axis=1)
        for name, (xa, xb) in (("sorted", (ta, tb)), ("unsorted_a", (sa, tb)),
                               ("unsorted_b", (ta, sb)),
                               ("unsorted_both", (sa, sb))):
            check(xa, xb, dta, dtb, del_g,
                  f"NG={ng} tie-free {name} rows={HARD_ROWS}",
                  vs_plain32=False)
    _print(f"hard rows at NG {HARD_NGS}, {HARD_ROWS} rows: fused primal "
           "equal to kernel 1's bit for bit on every case, tangents finite")
    return record


def _fused_launches(fn):
    """(result of fn(), fused-kernel launches it made), counted from 0."""
    import torch

    from archnemesis_tpu_torch.ops.overlap_cuda import (
        combine_pair_with_tangents,
    )

    combine_pair_with_tangents.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, combine_pair_with_tangents.launches


def _jacobian_launches(fn):
    """(result of fn(), kernel-1t launches, ``emission_tangent`` launches
    it made), each counted from 0."""
    from archnemesis_tpu_torch.ops.tangent_cuda import emission_tangent

    emission_tangent.launches = 0
    out, fused = _fused_launches(fn)
    return out, fused, emission_tangent.launches


def copy_deck(src: str, base: str) -> str:
    """A copy of a deck under ``base`` with the shared k-tables linked
    beside it (its .kls names them by relative path)."""
    dst = os.path.join(base, "deck")
    shutil.copytree(src, dst)
    os.symlink(os.path.abspath("tests/fixtures/ktables"),
               os.path.join(base, "ktables"))
    return dst


def phase_retrieval(profile: bool = False):
    """The OE retrieval through the port's entry points on the card;
    returns the fused kernel's launches in one forward-plus-Jacobian
    evaluation of the full deck."""
    import torch

    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
    from archnemesis_tpu_torch.retrievals import (
        make_retrieval_setup,
        retrieval_nemesis,
    )

    # --- the full deck in float64 against the reference goldens
    d = np.load(OE_GOLDEN)
    fd = np.load(FD_GOLDEN)
    s64 = make_retrieval_setup(DECK, "cirstest", device="cuda")
    np.testing.assert_allclose(s64.sv.xa, d["XA"], rtol=1e-10)
    np.testing.assert_allclose(s64.sv.sa, d["SA"], rtol=1e-8)
    np.testing.assert_allclose(s64.y, d["Y"], rtol=1e-10)
    np.testing.assert_allclose(np.diag(s64.se), np.diag(d["SE"]), rtol=1e-10)
    nx, ny = s64.sv.nx, s64.y.shape[0]
    xn = torch.as_tensor(d["XN"], device="cuda")
    j = int(fd["J"])
    tangent = torch.zeros(nx, dtype=torch.float64, device="cuda")
    tangent[j] = 1.0
    yn_jvp, dy = torch.func.jvp(s64.forward_fn, (xn,), (tangent,))
    np.testing.assert_allclose(yn_jvp.cpu().numpy(), d["YN"], rtol=0,
                               atol=5e-5 * np.abs(d["YN"]).max())
    np.testing.assert_allclose(dy.cpu().numpy(), fd["COL"], rtol=0,
                               atol=3e-5 * np.abs(fd["COL"]).max())

    # the main path of this slice, counted on its own: one
    # forward-plus-Jacobian evaluation, all 81 tangents in one pass
    (yn64, kk64), launches, emission = _jacobian_launches(
        lambda: forward_and_jacobian(s64.forward_fn, xn))
    if (launches, emission) != (6, 1):
        raise AssertionError(f"{launches} fused and {emission} emission "
                             "tangent launches, expected 6 and 1")
    if kk64.shape != (ny, nx) or not torch.isfinite(kk64).all():
        raise AssertionError(f"Jacobian not finite ({ny}, {nx})")
    np.testing.assert_allclose(
        kk64[:, j].cpu().numpy(), dy.cpu().numpy(), rtol=1e-10,
        atol=1e-12 * kk64.abs().max().item())
    torch.testing.assert_close(yn64, yn_jvp, rtol=1e-12, atol=0)
    _print(f"jupiter_nadir float64 on the card (NX={nx}, NY={ny}): a priori "
           "and measurement vector equal the golden; forward_fn(XN) within "
           "5e-5 and the JVP column within 3e-5 of peak of the reference; "
           "jacfwd column equals the JVP; 6 fused launches and 1 emission "
           "tangent launch per evaluation")

    # --- the whole retrieval on the reduced deck against the reference
    g = np.load(RETRIEVAL_GOLDEN)
    with tempfile.TemporaryDirectory() as tmp:
        deck = copy_deck(FDRET, tmp)
        res = retrieval_nemesis(deck, "cirstest", niter=int(g["niter"]),
                                philimit=float(g["philimit"]),
                                write_outputs=False, device="cuda")
    yn_ref, xn_ref, st_ref = g["YN"], g["XN"], g["ST"]
    np.testing.assert_allclose(res.yn, yn_ref, rtol=5e-3,
                               atol=np.median(np.abs(yn_ref)) * 1e-4)
    np.testing.assert_allclose(res.xn, xn_ref, rtol=1e-3,
                               atol=1e-3 * np.abs(xn_ref).max())
    phi_ref = np.asarray(g["PHI_HIST"], dtype=float)
    n = min(len(phi_ref), len(res.phi_history))
    np.testing.assert_allclose(res.phi_history[:n], phi_ref[:n], rtol=1e-3)
    scale = np.abs(np.diagonal(st_ref)).max()
    np.testing.assert_allclose(res.st, st_ref, rtol=2e-2, atol=scale * 5e-3)
    np.testing.assert_allclose(np.diagonal(res.st), np.diagonal(st_ref),
                               rtol=2e-2)
    _print(f"jupiter_fdret retrieval float64 on the card: {res.n_iter} "
           f"iterations, phi {['%.6e' % p for p in res.phi_history]}; YN, XN, "
           "PHI_HIST, ST within the reference trajectory's tolerances")

    # --- timing of one evaluation, float64 and float32
    s32 = make_retrieval_setup(DECK, "cirstest", device="cuda",
                               dtype=torch.float32)
    xn32 = xn.float()
    results = {}
    for name, setup, x in (("float64", s64, xn), ("float32", s32, xn32)):
        forward_and_jacobian(setup.forward_fn, x)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(JACOBIAN_RUNS):
            t0 = time.perf_counter()
            out, launched, emission = _jacobian_launches(
                lambda: forward_and_jacobian(setup.forward_fn, x))
            times.append((time.perf_counter() - t0) * 1e3)
            if (launched, emission) != (6, 1):
                raise AssertionError(f"{launched} fused and {emission} "
                                     f"emission tangent launches ({name})")
        peak = torch.cuda.max_memory_allocated()
        results[name] = out
        _print(f"forward-plus-Jacobian on jupiter_nadir ({nx} tangents, "
               f"{name}): median {np.median(times):.3f} ms over "
               f"{len(times)} runs (min {min(times):.3f}, max "
               f"{max(times):.3f}); peak memory {peak / 2**30:.3f} GiB")
        del out
    yn32, kk32 = results["float32"]
    r = rel_err(yn32.double().cpu().numpy(), yn64.cpu().numpy())
    col_peak = kk64.abs().max(dim=0).values
    jac_err = ((kk32.double() - kk64).abs().max(dim=0).values
               / col_peak).max().item()
    _print(f"retrieval float32 vs float64: spectrum max rel {r.max():.3e}, "
           f"median rel {np.median(r):.3e}; Jacobian max error over column "
           f"peak {jac_err:.3e} (bound {JAC_F32_BOUND:.1e})")
    if not (r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1]):
        raise AssertionError("float32 retrieval spectrum outside 1e-4 / 1e-5")
    if not jac_err < JAC_F32_BOUND:
        raise AssertionError("float32 Jacobian outside its bound")
    results.clear()

    # --- wall-clock of a 3-iteration retrieval on the full deck
    for name, dtype in (("float64", torch.float64),
                        ("float32", torch.float32)):
        t0 = time.perf_counter()
        res3, launched = _fused_launches(lambda: retrieval_nemesis(
            DECK, "cirstest", niter=3, philimit=0.001, write_outputs=False,
            device="cuda", dtype=dtype))
        wall = time.perf_counter() - t0
        hist = res3.phi_history
        if not (np.isfinite(res3.xn).all() and hist[-1] < hist[0]):
            raise AssertionError(f"retrieval ({name}) did not reduce phi")
        _print(f"retrieval_nemesis(jupiter_nadir, niter=3, {name}): "
               f"{wall:.3f} s wall, {res3.n_iter} iterations accepted, "
               f"{launched} fused launches, phi "
               f"{['%.6e' % p for p in hist]}")

    if profile:
        profile_forward(
            lambda: forward_and_jacobian(s64.forward_fn, xn), runs=1,
            what="forward-plus-Jacobian (float64, 81 tangents)",
            trace="build/jacobian_trace.json")
        profile_forward(
            lambda: forward_and_jacobian(s32.forward_fn, xn32), runs=1,
            what="forward-plus-Jacobian (float32, 81 tangents)",
            trace="build/jacobian32_trace.json")
    return launches


# ---- runtime line-by-line slice ------------------------------------------

def _lbl_bound_inputs(ll, blocks, t, p, amb) -> tuple:
    """What ``nembench.harness.bounds.lbl_pair_counts`` takes before the
    windows: the line centres, the (NLAY, NLINE) strengths, widths and
    shifts at (NLAY,) float64 t, p [atm] and amb, and the wave grid."""
    import torch

    from archnemesis_tpu_torch.ops.lbl import layer_line_params

    params = (x.numpy() for x in layer_line_params(
        ll, *(torch.as_tensor(np.asarray(x, dtype=np.float64))
              for x in (t, p, amb))))
    return (ll.nu, *params, blocks.wn_pad[:blocks.n_wave])


def lbl_pair_counts(ll, blocks, t, p, amb, wn_calc=25.0, wn_approx=75.0):
    """(core_cf, core_weideman, wing, lines) pair counts of one synthesis,
    from its inputs (``nembench.harness.bounds.lbl_pair_counts``)."""
    return bench_bounds.lbl_pair_counts(
        *_lbl_bound_inputs(ll, blocks, t, p, amb), wn_calc, wn_approx)


def lbl_bound_ms(ll, blocks, t, p, amb, itemsize: int) -> tuple:
    """(bound_ms, bound_by, ops) of one synthesis on an H100 at the 25 and
    75 cm-1 windows (``nembench.harness.bounds.lbl_bound_ms``); ``ops``:
    the operations that take ``bound_ms`` at the peak of the type, the
    synthesis's own count where they bound it."""
    nu, s, *rest = _lbl_bound_inputs(ll, blocks, t, p, amb)
    ms = bench_bounds.lbl_bound_ms(nu, s, *rest, 25.0, 75.0, itemsize)
    # no line of non-zero strength needs an operation: the bytes' bound
    bytes_ms = bench_bounds.lbl_bound_ms(nu, np.zeros_like(s), *rest, 25.0,
                                         75.0, itemsize)
    peak = PEAK_F32_OPS_S if itemsize == 4 else PEAK_F64_OPS_S
    return (ms, "operations" if ms > bytes_ms else "bytes",
            ms * 1e-3 * peak)


# the pressure-shift case of phase 7: ambient shifts of +-0.95 cm-1/atm
# (alternating by line) and layers up to 1.95 atm move line centres by up
# to 1.67 cm-1, less than build_blocks' 2 cm-1 shift margin, against 2.54
# cm-1 blocks of co_lbl's 0.02 cm-1 grid: the core/wing boundaries of many
# (block, line) pairs move across a block. (T [K], p [atm], ambient
# fraction) per layer
SHIFT_D_AMB = 0.95
SHIFT_CASE_STATE = ((150.0, 0.01, 1.0), (250.0, 1.0, 1.0), (220.0, 1.95, 0.9))


def shifted_lines(ll):
    """The line list with the shift case's ambient pressure shifts."""
    import dataclasses

    broad = ll.broad.copy()
    broad[5] = SHIFT_D_AMB * np.where(np.arange(ll.n_lines) % 2, 1.0, -1.0)
    return dataclasses.replace(ll, broad=broad)


# (block, line) classes of the LBL pair pass and the margin of its class
# test, relative to wn_approx + 1 cm-1 (csrc/lbl_cross_section.cu:
# line_class)
SKIP, WING, CORE, STRADDLE = 0, 1, 2, 3
CLASS_MARGIN = 1.0e-4


def block_line_classes(spec, t, p, amb):
    """(NLAY, NB, M) classes of the LBL pair pass for the lines of every
    block (``blocks.line_idx``; ``SKIP`` on padding and on zero strength),
    from the deltas at each block's first and last wave in the kernel's
    arithmetic and ``t``'s type: the host's copy of the rule of the
    kernel's ``line_class``, which the kernel applies on the card while it
    stages the lines. A class other than ``STRADDLE`` holds for every wave
    between, since the computed delta is monotone in the wave up to a few
    ulps, well inside the margin."""
    import torch

    from archnemesis_tpu_torch.ops.lbl import (
        layer_line_params,
        line_column,
        two_float,
        uses_two_float,
    )

    ll, blocks = spec.ll, spec.blocks
    strength, _, _, shift = layer_line_params(ll, t, p, amb)
    if not spec.include_pressure_shift:
        shift = torch.zeros_like(shift)
    dev = t.device
    idx = torch.as_tensor(blocks.line_idx, dtype=torch.long, device=dev)
    w = blocks.block_width
    ends = np.stack([blocks.wn_pad[::w], blocks.wn_pad[w - 1::w]], axis=1)
    if uses_two_float(ll, t.dtype):
        nu_hi, nu_lo = (torch.as_tensor(x, device=dev)[idx][None, :, :, None]
                        for x in two_float(ll.nu))
        e_hi, e_lo = (torch.as_tensor(x, device=dev)[None, :, None, :]
                      for x in two_float(ends))
        d = ((e_hi - nu_hi) + (e_lo - nu_lo)) - shift[:, idx][..., None]
    else:
        centre = line_column(ll.nu, t)[idx][None] + shift[:, idx]
        d = t.new_tensor(ends)[None, :, None, :] - centre[..., None]
    wc, wa = spec.wn_calc_window, spec.wn_approx_window
    margin = CLASS_MARGIN * (abs(wa) + 1.0)
    wcore = min(wc, wa)
    first, last = d[..., 0], d[..., 1]
    cls = torch.full(first.shape, STRADDLE, dtype=torch.int64, device=dev)
    cls[((first >= wc + margin) & (last < wa - margin))
        | ((first >= -wa + margin) & (last < -wc - margin))] = WING
    cls[(first >= -wcore + margin) & (last < wcore - margin)] = CORE
    cls[(last < -wa - margin) | (first >= wa + margin)] = SKIP
    s = strength[:, idx]
    mask = torch.as_tensor(blocks.line_mask > 0, device=dev)
    return torch.where((s >= spec.s_floor) & (s != 0) & mask, cls, SKIP)


def class_changes(spec, t, p, amb) -> tuple:
    """(class counts (skip, wing, core, straddle) over all layers, number
    of (layer, block, line) whose class differs from the one without the
    pressure shift) of the pair pass by the host's rule
    (``block_line_classes``), in ``t``'s type, layer by layer."""
    import dataclasses

    import torch

    unshifted = dataclasses.replace(spec, include_pressure_shift=False)
    counts, changed = np.zeros(4, dtype=np.int64), 0
    for i in range(t.shape[0]):
        lay = (t[i:i + 1], p[i:i + 1], amb[i:i + 1])
        cls = block_line_classes(spec, *lay)
        counts += torch.bincount(cls.reshape(-1), minlength=4).cpu().numpy()
        changed += int((cls != block_line_classes(unshifted, *lay)).sum())
    return counts, changed


def lbl_kernel_and_plain(ll, blocks, t, p, amb, **kw):
    """(kernel, plain) k of one synthesis on the card: the wrapper's launch
    and the plain version on the same (NLAY,) CUDA tensors."""
    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.ops.lbl import lbl_cross_section_plain

    k = lbl_cuda.lbl_cross_section(ll, blocks, t, p, amb, **kw)
    return k, lbl_cross_section_plain(ll, blocks, t, p, amb, **kw)


def _lbl_f32_check(k32, k64, what: str) -> tuple:
    """float32 against float64 at the LBL float32 bound; returns (max,
    median) relative error."""
    r = rel_err(k32.double().cpu().numpy(), k64.double().cpu().numpy())
    ok = r.max() < LBL_F32_BOUNDS[0] and np.median(r) < LBL_F32_BOUNDS[1]
    _print(f"{what}: float32 vs float64 max rel {r.max():.3e}, median rel "
           f"{np.median(r):.3e} ({'ok' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"{what}: float32 outside "
                             f"{LBL_F32_BOUNDS[0]:.0e} / {LBL_F32_BOUNDS[1]:.0e}")
    return float(r.max()), float(np.median(r))


def _lbl_f64_check(k, ref, what: str):
    """float64 kernel against float64 ``ref`` at ``LBL_F64_RTOL``."""
    import torch

    err = ((k - ref).abs() / ref.abs().clamp_min(1e-300)).max().item()
    ok = torch.allclose(k, ref, rtol=LBL_F64_RTOL, atol=0.0)
    _print(f"{what}: float64 max rel {err:.3e} ({'ok' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"{what}: float64 outside rtol {LBL_F64_RTOL}")


def phase_lbl_kernel_vs_plain():
    """The LBL kernel against its plain version and the reference on the
    card; returns the record of the full-width configuration."""
    import dataclasses

    import torch

    from archnemesis_tpu_torch.forward import (
        ATM_TO_PA,
        forward_nadir,
        runtime_ambient_fraction,
    )
    from archnemesis_tpu_torch.io.linedata import (
        _slice_lines,
        read_ans_linedata,
    )
    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.ops.lbl import (
        build_blocks,
        lbl_cross_section_plain,
    )
    from archnemesis_tpu_torch.ops.voigt import LINESHAPES
    from archnemesis_tpu_torch.synthetic import lbl_headline

    def card(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device="cuda")

    ll = read_ans_linedata(LINEDATA_NPZ, gas_id=5, iso_id=1)
    # --- the reference's cross-sections (tests/test_lbl.py)
    d = np.load(CO_LBL_GOLDEN)
    blocks = build_blocks(d["WAVE"], ll.nu)
    t, p, amb = (card(d["CASES"][:, i]) for i in range(3))
    k64, plain64 = lbl_kernel_and_plain(ll, blocks, t, p, amb)
    _lbl_f64_check(k64, plain64, "co_lbl kernel vs plain")
    _lbl_f64_check(k64, card(d["K"]), "co_lbl kernel vs reference")
    k32 = lbl_cuda.lbl_cross_section(ll, blocks, t.float(), p.float(),
                                     amb.float())
    _lbl_f32_check(k32, card(d["K"]), "co_lbl kernel")

    # --- every lineshape on the same grid and cases with s_floor > 0, no
    # shift and the iso-0 factor, at block widths 128, 200, 1 and 512 (the
    # last three not multiples of the waves per thread, 512 the largest
    # block), and with the lines above 2100 cm-1 dropped, so that the upper
    # blocks hold none
    ll0 = dataclasses.replace(ll, iso_id=0)
    for lls, width in ((ll0, 128), (ll0, 200), (ll0, 1), (ll0, 512),
                       (_slice_lines(ll0, 2000.0, 2100.0), 128)):
        blk = build_blocks(d["WAVE"], lls.nu, block_width=width)
        empty = int((blk.counts == 0).sum())
        for shape in LINESHAPES:
            kw = dict(lineshape=shape, s_floor=1.0e-25,
                      include_pressure_shift=False)
            k64, plain64 = lbl_kernel_and_plain(lls, blk, t, p, amb, **kw)
            what = (f"{shape}, W={width}, {lls.n_lines} lines, {empty} "
                    "blocks without lines")
            _lbl_f64_check(k64, plain64, what)
            k32 = lbl_cuda.lbl_cross_section(lls, blk, t.float(), p.float(),
                                             amb.float(), **kw)
            _lbl_f32_check(k32, plain64, what)
    if empty == 0:
        raise AssertionError("the last grid has no block without lines")

    # --- the pressure-shift case: line centres moved across the blocks'
    # core/wing boundaries, every lineshape
    lls = shifted_lines(ll)
    blk = build_blocks(d["WAVE"], lls.nu)
    ts, ps, ambs = (card(v) for v in zip(*SHIFT_CASE_STATE))
    counts, changed = class_changes(lbl_cuda.make_spec(lls, blk),
                                    ts.float(), ps.float(), ambs.float())
    _print(f"shift case: (block, line) classes skip / wing / core / straddle "
           f"{counts.tolist()}, {changed} differ from the unshifted ones")
    if changed == 0:
        raise AssertionError("the shift case moves no line across a class")
    # float32 against the plain float32 version: a float32 shift of ~1.7
    # cm-1 is itself off by ~1e-7 cm-1, which moves a narrow Gaussian's
    # far core by up to ~1.7e-4 relative in both versions alike; against
    # float64, the kernel may be no further off than the plain float32
    # version plus the float32 bound
    for shape in LINESHAPES:
        k64, plain64 = lbl_kernel_and_plain(lls, blk, ts, ps, ambs,
                                            lineshape=shape)
        _lbl_f64_check(k64, plain64, f"{shape}, shift case")
        k32, plain32 = lbl_kernel_and_plain(lls, blk, ts.float(), ps.float(),
                                            ambs.float(), lineshape=shape)
        _lbl_f32_check(k32, plain32, f"{shape}, shift case, kernel vs plain")
        want = plain64.cpu().numpy()
        r_k, r_p = (rel_err(x.double().cpu().numpy(), want)
                    for x in (k32, plain32))
        ok = (r_k.max() < r_p.max() + LBL_F32_BOUNDS[0]
              and np.median(r_k) < LBL_F32_BOUNDS[1])
        _print(f"{shape}, shift case, against float64: kernel float32 max "
               f"rel {r_k.max():.3e} (median {np.median(r_k):.3e}), plain "
               f"float32 max rel {r_p.max():.3e} (median "
               f"{np.median(r_p):.3e}) ({'ok' if ok else 'FAIL'})")
        if not ok:
            raise AssertionError(f"{shape}, shift case: the float32 kernel "
                                 "is further from float64 than the plain "
                                 "float32 version allows")

    # --- the full-width configuration, at the inputs its forward gives
    atm, laycfg, rt, surf, cfg = lbl_headline(dtype=torch.float32,
                                              device="cuda")
    _, diag = forward_nadir(atm, laycfg, rt, None, None, surf, cfg,
                            emiss_ang=0.0, return_diagnostics=True,
                            device="cuda")
    layers = diag["layers"]
    t32 = layers.temp
    p32 = layers.press / ATM_TO_PA
    amb32 = runtime_ambient_fraction(cfg, layers, 0)
    lls, blk = rt.line_lists[0], rt.blocks[0]
    spec = lbl_cuda.make_spec(lls, blk)
    static = lbl_cuda.kernel_inputs(spec, torch.float32, t32.device)

    def kernel():
        return lbl_cuda.lbl_cross_section(
            lls, blk, t32, p32, amb32,
            packed={(torch.float32, t32.device): static})

    def plain():
        return lbl_cross_section_plain(lls, blk, t32, p32, amb32)

    k32 = kernel()
    same = torch.equal(k32, kernel())
    _print(f"full width: two float32 launches equal bit for bit: {same} "
           f"({'ok' if same else 'FAIL'})")
    if not same:
        raise AssertionError("two full-width launches differ")
    ms = _cuda_ms(kernel, reps=LBL_KERNEL_RUNS)
    state = (t32, p32, amb32)
    # the two passes' device times (the line pass alone is too short for
    # events around its launches, which would time the host)
    by_kernel = kernel_device_ms(kernel)
    line_ms, pair_ms = (sum(v for k, v in by_kernel.items() if name in k)
                        for name in ("line_kernel", "pair_kernel"))
    counts, changed = class_changes(spec, *state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain32 = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (k32 - plain32).abs().max().item()
    _lbl_f32_check(k32, plain32, "full width, kernel vs plain (float32)")
    del plain32
    sel = list(LBL_COMPARE_LAYERS)
    t64, p64, a64 = (x[sel].double() for x in (t32, p32, amb32))
    k64, plain64 = lbl_kernel_and_plain(lls, blk, t64, p64, a64)
    _lbl_f64_check(k64, plain64, f"full width, layers {sel}")
    _lbl_f32_check(k32[:, sel], plain64, f"full width, layers {sel}")
    del k64, plain64
    host = [x.double().cpu().numpy() for x in (t32, p32, amb32)]
    bound_ms, bound_by, ops = lbl_bound_ms(lls, blk, *host, itemsize=4)
    cf, weid, wing, lines = lbl_pair_counts(lls, blk, *host)
    _print(f"lbl_cross_section at {blk.n_wave} waves x {lls.n_lines} lines x "
           f"{len(t32)} layers, float32: kernel {ms:.4f} ms, plain "
           f"{plain_ms:.4f} ms (all {len(t32)} layers, one call), bound "
           f"{bound_ms:.4f} ms ({bound_by}; {ops:.4e} operations: "
           f"{cf:.4e} continued-fraction and {weid:.4e} Weideman core pairs, "
           f"{wing:.4e} wing pairs, {lines} (layer, line) terms); "
           f"max_abs_err {err:.3e}")
    _print(f"lbl_cross_section passes (device time, torch.profiler): line "
           f"pass {line_ms:.4f} ms, pair pass {pair_ms:.4f} ms, beside the "
           f"bound {bound_ms:.4f} ms; (block, line) classes skip / wing / "
           f"core / straddle {counts.tolist()} over {len(t32)} layers "
           f"({changed} moved by the pressure shift)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def copy_runtime_deck(base: str) -> str:
    """A copy of the runtime deck under ``base`` whose ``.lls`` reads the
    line data from its ``.npz`` export (DBASE_LD / DBASE_PF), so that a
    machine without h5py reads it through the port's ``load_deck``."""
    dst = os.path.join(base, "deck")
    shutil.copytree(CO_RUNTIME, dst)
    lls = os.path.join(dst, "cirstest.lls")
    with open(lls) as f:
        lines = f.readlines()
    npz = os.path.abspath(LINEDATA_NPZ)
    with open(lls, "w") as f:
        for line in lines:
            key = line.split()[0] if line.split() else ""
            f.write(f"{key:<17}{npz}\n" if key in ("DBASE_LD", "DBASE_PF")
                    else line)
    return dst


# The ILBL = 1 tangent decks of phase 26: co_runtime (CO at 2110-2190 cm-1,
# 10 layers of a Mars-like 0-60 km atmosphere) with a limb, solar-occultation
# or transit geometry written in.

LINEDATA_H5 = "tests/fixtures/linedata/CO_1_ambient_AIR.h5"
# kind -> (tangent heights in km (EMISS_ANG < 0: SOL_ANG is TANHE), FWHM in
# cm-1 (0: channel interpolation; > 0: the Gaussian ILS), channel centres,
# IFORM, Doppler velocity in km/s). The lowest limb tangent lies in the
# bottom layer, so that every level's temperature reaches the spectrum: with
# all tangents above it, the surface level's column is zero but for float64
# rounding, many orders under the other columns.
LBL_TANGENT_DECKS = {
    "limb": ((3.0, 22.0, 37.0), 0.0, np.arange(2145.0, 2152.5, 1.0), 0,
             0.0),
    "so": ((6.0, 14.0, 23.0, 31.0, 42.0), 0.5, np.arange(2145.0, 2152.5, 1.0),
           0, 1.5),
    "transit": ((0.0,), 0.25, np.arange(2141.0, 2153.0, 1.0), 2, 0.0),
}
# the calc grid (first, last, step in cm-1) of every kind: co_runtime's
# 2110-2190 cm-1 cut to the channels' reach. A runtime deck synthesises its
# whole .lls grid whatever its channels, and the JAX package's eager jacfwd
# in the CPU tests takes time in proportion to it.
LBL_TANGENT_WAVE = (2138.0, 2156.0, 0.05)
# the measurement of each kind (radiance in W cm-2 sr-1 (cm-1)-1,
# transmission, transit depth in percent) and its error
LBL_TANGENT_MEAS = {"limb": (2.0e-9, 2.0e-10), "so": (0.9, 0.01),
                    "transit": (2.5e-3, 2.0e-5)}
# the stellar radius (km) of the transit deck and of phase 26's full-width
# transit forward, and the deck's inline stellar spectrum (read_sol's "-1"
# form): ISPACE, radius, then (wave, power) rows
LBL_GEOM_STELLAR_KM = 6.957e5
LBL_TRANSIT_SOL = (f"-1\n0\n{LBL_GEOM_STELLAR_KM}\n"
                   "2000.0 1.0e22\n2100.0 1.1e22\n2200.0 1.2e22\n"
                   "2300.0 1.3e22\n")
# the CO profile of the state vector (model 0, log VMR): the .ref's VMR and
# an error of 20 % of it
LBL_CO_VMR = 4.0e-2
LBL_CO_APR_ERROR = 0.2


def _replace_lines(path: str, edit) -> None:
    with open(path) as f:
        lines = f.readlines()
    with open(path, "w") as f:
        f.writelines(edit(lines))


def lbl_tangent_deck(base: str, kind: str, linedata: str = LINEDATA_NPZ
                     ) -> str:
    """A copy of the runtime deck (ILBL = 1) under ``base`` as a ``kind``
    deck (``LBL_TANGENT_DECKS``: "limb", "so" or "transit"), its ``.lls``
    reading the line data from ``linedata`` (the ``.h5``, or its ``.npz``
    export where h5py is missing) on the grid ``LBL_TANGENT_WAVE``. It
    writes a tangent-height ``.spx``
    (EMISS_ANG = -1, SOL_ANG the tangent height, the form of
    ``tests/fixtures/jupiter_limb/cirstest.spx``), the IFORM and Doppler
    velocity into the ``.inp``, an ``.apr`` of the temperature and the CO
    profile (model 0 both), and for the transit deck ISOL = 1 in the
    ``.set`` and an inline ``.sol`` with the stellar radius."""
    tanhe, fwhm, vconv, iform, v_doppler = LBL_TANGENT_DECKS[kind]
    meas, err = LBL_TANGENT_MEAS[kind]
    dst = os.path.join(base, kind)
    shutil.copytree(CO_RUNTIME, dst)
    run = os.path.join(dst, "cirstest")
    data = os.path.abspath(linedata)
    grid = " ".join(str(v) for v in LBL_TANGENT_WAVE)

    def lls(line):
        key = line.split()[0] if line.split() else ""
        if key in ("DBASE_LD", "DBASE_PF"):
            return f"{key:<17}{data}\n"
        return f"{key:<17}{grid}\n" if key == "WAVE" else line

    _replace_lines(run + ".lls", lambda lines: [lls(ln) for ln in lines])
    _replace_lines(run + ".inp", lambda lines: lines[:7] + [
        f"{iform}\n", f"{v_doppler}\n"])
    with open(run + ".spx", "w") as f:
        f.write(f"{fwhm} 0.0 0.0 {len(tanhe)}\n")
        for th in tanhe:
            f.write(f"{len(vconv)}\n1\n0.0 0.0 {th} -1.0 0.0 1.0\n")
            f.writelines(f"{v:.4f} {meas:.6e} {err:.6e}\n" for v in vconv)
    # model 0 for the CO column on the temperature profile's levels
    ref = np.loadtxt(os.path.join(dst, "testapr.dat"), skiprows=1)
    with open(os.path.join(dst, "coapr.dat"), "w") as f:
        f.write(f"{ref.shape[0]} 1.5\n")
        f.writelines(f"{p:.6e} {LBL_CO_VMR:.6e} "
                     f"{LBL_CO_APR_ERROR * LBL_CO_VMR:.6e}\n"
                     for p in ref[:, 0])
    with open(run + ".apr", "w") as f:
        f.write("*** ILBL = 1 tangent deck: temperature and CO ***\n2\n"
                "0 0 0\ntestapr.dat\n5 1 0\ncoapr.dat\n")
    if kind == "transit":
        _replace_lines(run + ".set", lambda lines: [
            ln.replace("off(0) :  0", "off(0) :  1")
            if ln.lstrip().startswith("Sunlight") else ln for ln in lines])
        with open(run + ".sol", "w") as f:
            f.write(LBL_TRANSIT_SOL)
    return dst


def runtime_deck_forward(deck_dir: str, dtype, device):
    """(TAUGAS, SPECONV, launches) of the runtime deck as
    ``tests/test_forward_runtime.py`` sets it up (the a-priori state
    applied, lines windowed to the channel range), through the port."""
    import torch

    from archnemesis_tpu_torch.core.spectra import cast_deck
    from archnemesis_tpu_torch.forward import forward_nadir, make_forward_config
    from archnemesis_tpu_torch.io.legacy import load_deck
    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.ops.convolution import conv_channel_interp
    from archnemesis_tpu_torch.retrieval.statevector import (
        apply_state,
        read_apr,
    )

    deck = load_deck(deck_dir, "cirstest")
    sv = read_apr(os.path.join(deck_dir, "cirstest.apr"), deck.atmosphere)
    atm = apply_state(deck.atmosphere, torch.as_tensor(sv.xa), sv)
    nconv = int(deck.geometry.nconv[0])
    vconv = deck.geometry.vconv[:nconv, 0]
    rt = deck.ktables.windowed(vconv.min(), vconv.max())
    cfg = make_forward_config(atm, rt, None, iray=deck.settings.iray,
                              ispace=deck.settings.ispace, gasgiant=True)
    atm, surf = cast_deck(atm, dtype), cast_deck(deck.surface, dtype)
    lbl_cuda.lbl_cross_section.launches = 0
    spec, diag = forward_nadir(atm, deck.layer_config, rt, None, None, surf,
                               cfg, emiss_ang=0.0, return_diagnostics=True,
                               device=device)
    launches = lbl_cuda.lbl_cross_section.launches
    conv = conv_channel_interp(spec.new_tensor(rt.wave), spec[:, 0],
                               spec.new_tensor(vconv))
    return diag["taugas"], conv, launches


def phase_lbl_golden_deck():
    """The runtime deck through the port's load_deck on the card."""
    d = np.load(CO_RUNTIME_GOLDEN)
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        deck = copy_runtime_deck(tmp)
        tau64, conv64, n64 = runtime_deck_forward(deck, torch.float64, "cuda")
        _, conv32, n32 = runtime_deck_forward(deck, torch.float32, "cuda")
    want = d["TAUGAS"]
    np.testing.assert_allclose(tau64.cpu().numpy(), want, rtol=1e-7,
                               atol=1e-10 * np.abs(want).max())
    nconv = int(d["NCONV"][0])
    np.testing.assert_allclose(conv64.cpu().numpy(), d["SPECONV"][:nconv, 0],
                               rtol=1e-6, atol=0)
    if (n64, n32) != (1, 1):
        raise AssertionError(f"{n64}, {n32} launches per forward, expected 1")
    _print("runtime deck float64 (line data from the .npz export): TAUGAS "
           "within rtol 1e-7, SPECONV within rtol 1e-6 of the golden; 1 "
           "launch per forward")
    _lbl_f32_check(conv32, conv64, "runtime deck SPECONV")


def phase_lbl_headline(profile: bool = False):
    """Drive the runtime line-by-line headline forward; returns (launches of
    the main path, median ms)."""
    import torch

    from archnemesis_tpu_torch.forward import forward_nadir
    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.synthetic import LBL_NWAVE, lbl_headline

    atm, laycfg, rt, surf, cfg = lbl_headline(dtype=torch.float32,
                                              device="cuda")

    def forward():
        return forward_nadir(atm, laycfg, rt, None, None, surf, cfg,
                             emiss_ang=0.0, device="cuda")

    # the main path, counted on its own
    lbl_cuda.lbl_cross_section.launches = 0
    spec = forward()
    torch.cuda.synchronize()
    launches = lbl_cuda.lbl_cross_section.launches
    if launches != 1:
        raise AssertionError(f"{launches} LBL launches, expected 1")
    if spec.shape != (LBL_NWAVE, 1) or not torch.isfinite(spec).all():
        raise AssertionError(f"LBL headline spectrum not finite "
                             f"({LBL_NWAVE}, 1)")

    torch.cuda.reset_peak_memory_stats()
    times = []
    before = lbl_cuda.lbl_cross_section.launches
    packs = lbl_cuda.kernel_inputs.calls
    for i in range(HEADLINE_RUNS + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        forward()
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    if lbl_cuda.lbl_cross_section.launches - before != HEADLINE_RUNS + 2:
        raise AssertionError("LBL launches did not rise by 1 per forward")
    packs = lbl_cuda.kernel_inputs.calls - packs
    _print(f"static kernel inputs packed in {HEADLINE_RUNS + 2} forwards "
           f"after the first: {packs} ({'ok' if packs == 0 else 'FAIL'})")
    if packs:
        raise AssertionError("the LBL forward packs its static inputs per "
                             "call")
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(times))
    nlines = rt.line_lists[0].n_lines
    _print(f"LBL headline forward ({LBL_NWAVE} waves x {nlines} lines x "
           f"{laycfg.nlay} layers, float32): median {ms:.3f} ms over "
           f"{len(times)} runs (min {min(times):.3f}, max {max(times):.3f}); "
           f"{LBL_NWAVE / ms * 1e3:.1f} waves/s; peak memory "
           f"{peak / 2**30:.3f} GiB")

    atm64, laycfg, rt64, surf64, cfg = lbl_headline(dtype=torch.float64,
                                                    device="cuda")
    spec64 = forward_nadir(atm64, laycfg, rt64, None, None, surf64, cfg,
                           emiss_ang=0.0, device="cuda")
    _lbl_f32_check(spec, spec64, "LBL headline spectrum")
    if profile:
        profile_forward(forward, what="LBL headline forward",
                        trace="build/lbl_headline_trace.json")
    return launches, ms


def phase_lbl_retrieval():
    """The retrieval entry point on a copy of the runtime deck, on the card
    against the port's CPU result; returns the launches of one
    forward-plus-Jacobian evaluation."""
    import torch

    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
    from archnemesis_tpu_torch.retrievals import (
        make_retrieval_setup,
        retrieval_nemesis,
    )

    with tempfile.TemporaryDirectory() as tmp:
        deck = copy_runtime_deck(tmp)
        cpu = make_retrieval_setup(deck, "cirstest", device="cpu")
        gpu = make_retrieval_setup(deck, "cirstest", device="cuda")
        ngas = gpu.deck.ktables.ngas
        xa = torch.as_tensor(cpu.sv.xa)
        yn_cpu, kk_cpu = forward_and_jacobian(cpu.forward_fn, xa)
        y0 = gpu.forward_fn(xa.cuda())
        lbl_cuda.lbl_cross_section.launches = 0
        yn, kk = forward_and_jacobian(gpu.forward_fn, xa.cuda())
        torch.cuda.synchronize()
        launches = lbl_cuda.lbl_cross_section.launches
        if launches != ngas:
            raise AssertionError(f"{launches} LBL launches per evaluation, "
                                 f"expected {ngas}")
        for what, got, want in (("forward_fn(xa)", y0, yn_cpu),
                                ("spectrum", yn, yn_cpu)):
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       rtol=1e-10, atol=0, err_msg=what)
        # the Jacobian at rtol 1e-10 and, for entries that are rounding
        # noise (the first card run read 2 of 900 near 1e-31, 21 orders
        # under their column's peak), within 1e-10 of each column's peak
        col_peak = kk_cpu.abs().max(dim=0).values.numpy()
        np.testing.assert_array_less(
            np.abs(kk.cpu().numpy() - kk_cpu.numpy()),
            1e-10 * np.abs(kk_cpu.numpy()) + 1e-10 * col_peak[None, :]
            + np.finfo(np.float64).tiny)
        _print(f"runtime retrieval set-up on the card (NX={gpu.sv.nx}, "
               f"NY={gpu.y.shape[0]}), float64: forward_fn(xa) and the "
               f"spectrum equal the CPU's at rtol 1e-10, the Jacobian at "
               f"rtol 1e-10 + 1e-10 of each column's peak; {launches} "
               f"launch per evaluation ({ngas} gas)")
        hist = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res = retrieval_nemesis(deck, "cirstest", niter=3,
                                    write_outputs=False, device=device)
            wall = time.perf_counter() - t0
            hist[device] = res.phi_history
            if not (np.isfinite(res.xn).all()
                    and res.phi_history[-1] < res.phi_history[0]):
                raise AssertionError(f"runtime retrieval ({device}) did not "
                                     "reduce phi")
            _print(f"retrieval_nemesis(co_runtime, niter=3, float64, "
                   f"{device}): {wall:.3f} s wall, {res.n_iter} iterations, "
                   f"phi {['%.6e' % x for x in res.phi_history]}")
    np.testing.assert_allclose(hist["cuda"], hist["cpu"], rtol=1e-8)
    return launches



# ---- the last TPU kernels: the FMA-peak probe, the combine's variants,
# ---- the packed LBL shard entry; wave sharding over torch.distributed

# the wave shards of phases 13 and 14
N_SHARDS = 4


def phase_fma_peak():
    """Kernel 4 against its plain version bit for bit, its SASS, then the
    probe tool's measurement (the main path); returns the record."""
    from archnemesis_tpu_torch.ops import fma_peak
    from archnemesis_tpu_torch.tools import fma_peak as tool

    differ = tool.check()
    _print(f"fma_peak kernel vs plain on {tool.CHECK_ROWS * tool.COLS + 3} "
           f"random float32 elements: {differ} differ "
           f"({'ok' if differ == 0 else 'FAIL'})")
    if differ:
        raise AssertionError("the FMA probe differs from its plain version")
    ops = tool.sass_opcodes(fma_peak.build()["path"])
    if ops is None:
        _print("fma_peak SASS: no cuobjdump in the toolkit")
    else:
        # two unrolled copies of 4 elements x 2 chains x (2 + 256) FMAs
        # (the 16-byte path and the ragged end), nothing folded
        want = 2 * 4 * 2 * (fma_peak.STEPS + 1)
        _print(f"fma_peak SASS: {ops['FFMA']} FFMA (expected {want}), "
               f"{ops['FMUL']} FMUL, {ops['FADD']} FADD of "
               f"{sum(ops.values())} instructions")
        if ops["FFMA"] != want or ops["FMUL"]:
            raise AssertionError("the probe's loop is not the FFMA chains")

    # the main path, counted on its own
    fma_peak.fma_chain.launches = 0
    rec = tool.measure()
    launches = fma_peak.fma_chain.launches
    if rec["max_abs_err"] != 0.0:
        raise AssertionError("the probe differs from its plain version")
    numel = rec["flops"] // fma_peak.FLOPS_PER_ELEMENT
    bytes_ms = 8 * numel / PEAK_BYTES_S * 1e3
    ops_ms = rec["flops"] / PEAK_F32_OPS_S * 1e3
    _print(f"fma_peak at {tool.ROWS} x {tool.COLS} float32 ones: kernel "
           f"{rec['ms']:.4f} ms (median of 20), {rec['tflops']:.3f} TFLOP/s "
           f"= {rec['share']:.4f} of the data sheet's "
           f"{PEAK_F32_OPS_S / 1e12:.0f} TFLOP/s; plain {rec['plain_ms']:.3f} "
           f"ms; bound {ops_ms:.4f} ms (operations; bytes {bytes_ms:.4f}); "
           f"{launches} launches")
    return dict(launches=launches, max_abs_err=rec["max_abs_err"],
                ms=rec["ms"], plain_ms=rec["plain_ms"],
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=None)


def variant_f32_tol(del_g, mode: str) -> float:
    """float32 bound of a variant kernel's rebinned values against the
    float64 plain version, relative to each row's peak: ``tangent_f32_tol``
    for ``full`` (the rounding of an overlap's prefix sums against the
    narrowest bin, 2.7e-5 at NG = 20; the card's first run read 1.35e-5)
    and twice that for ``edges``, which subtracts two cumulative edge sums
    that reach the row's total (read 2.37e-5). The kernel and the plain
    float32 version are held to each other within three times the bound:
    the plain version's serial cumsum over NG^2 weights is the less
    accurate of the two (read 5.1e-5 and 6.0e-5 of the peak)."""
    return tangent_f32_tol(del_g) * (2.0 if mode == "edges" else 1.0)


def variant_bound_ms(mode: str, rows: int, ng: int, presorted: bool) -> tuple:
    """(bound_ms, bound_by) of one variant call in float32: the combine's
    bound for ``full`` and ``edges``; for ``sortonly`` the larger of the
    bytes and the merge of NG presorted runs of NG pair sums (the n pair
    sums and n ceil(log2 NG) comparisons); for ``rollonly`` the bytes in and
    out."""
    if mode in ("full", "edges"):
        return combine_bound_ms(rows, ng, 4, presorted)
    bytes_ms = 3 * rows * ng * 4 / PEAK_BYTES_S * 1e3
    if mode == "rollonly":
        return bytes_ms, "bytes"
    n = ng * ng
    ops_ms = rows * (n + n * _ceil_log2(ng)) / PEAK_F32_OPS_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


# NG of phase 12's checks, and the rows of those other than the tool's NG
VARIANT_NGS = (4, 20, 32)
VARIANT_CHECK_ROWS = 65_536


def _check_variants(a, b, del_g, kernel1) -> dict:
    """Every mode of kernel 3 on one input against its plain version:
    ``sortonly`` and ``rollonly`` bit for bit, and equal to their library
    calls; ``full`` equal to kernel 1 (``kernel1``, whose row code it runs)
    and to itself at every row tile bit for bit; ``full`` and ``edges``
    within ``variant_f32_tol`` of each row's peak of the float64 plain
    version and within three times it of the float32 one. Returns {mode:
    max abs error against the plain version}."""
    import torch

    from archnemesis_tpu_torch.ops import overlap_variants as ov

    rows, ng = a.shape
    n = ng * ng
    pairs = (a[:, :, None] + b[:, None, :]).reshape(rows, n)
    padded = pairs.new_full((rows, ov.ref_pad(ng)), torch.finfo(a.dtype).max)
    padded[:, :n] = pairs
    library = {
        "sortonly": ("torch.topk",
                     lambda: torch.topk(pairs, ng, largest=False).values),
        "rollonly": ("torch.roll", lambda: torch.roll(
            padded, ov.roll_shift(ng), dims=1)[:, :ng]),
    }
    errs = {}
    for mode in ov.MODES:
        got = ov.combine_lean(a, b, del_g, mode)
        plain = ov.combine_lean_plain(a, b, del_g, mode)
        torch.cuda.synchronize()
        errs[mode] = err = (got - plain).abs().max().item()
        line = f"overlap_variants {mode} vs plain at R={rows}, NG={ng}: "
        if mode in library:
            name, call = library[mode]
            same = torch.equal(got, plain)
            lib_same = torch.equal(call(), got)
            ok = same and lib_same
            line += (f"equal bit for bit: {same}; equal to the library call "
                     f"({name}): {lib_same}")
        else:
            ref = ov.combine_lean_plain(a.double(), b.double(), del_g, mode)
            peak = ref.abs().max(dim=1, keepdim=True).values.clamp_min(1e-300)
            k_err = ((got.double() - ref).abs() / peak).max().item()
            p_err = ((plain.double() - ref).abs() / peak).max().item()
            kp_err = ((got - plain).double().abs() / peak).max().item()
            tol = variant_f32_tol(del_g, mode)
            ok = k_err <= tol and kp_err <= 3 * tol
            line += (f"max_abs_err {err:.3e}; of each row's peak: kernel vs "
                     f"float64 {k_err:.3e}, plain float32 vs float64 "
                     f"{p_err:.3e}, kernel vs plain {kp_err:.3e} (bound "
                     f"{tol:.2e}, {3 * tol:.2e} between the two)")
            del ref
        if mode == "full":
            tiles = all(
                torch.equal(ov.combine_lean(a, b, del_g, mode, t), got)
                for t in ov.ROW_TILES[:-1])
            same_k1 = torch.equal(got, kernel1)
            ok = ok and tiles and same_k1
            line += (f"; equal to itself at every row tile: {tiles}; equal "
                     f"to kernel 1 bit for bit: {same_k1}")
        _print(f"{line} ({'ok' if ok else 'FAIL'})")
        if not ok:
            raise AssertionError(f"overlap variant {mode} disagrees (NG={ng})")
    return errs


def phase_overlap_variants():
    """Kernel 3, every mode against its plain version at NG 4, 20 (the
    tool's shape) and 32, then the variants tool (the main path) beside
    kernel 1, with the row code's stage split; returns one record per mode."""
    import torch

    from archnemesis_tpu_torch.ops import overlap_variants as ov
    from archnemesis_tpu_torch.ops.overlap_cuda import combine_pair
    from archnemesis_tpu_torch.tools import overlap_variants as tool

    for ng in VARIANT_NGS:
        if ng == tool.NG:
            continue
        a, b, del_g = tool.inputs(rows=VARIANT_CHECK_ROWS, ng=ng)
        _check_variants(a, b, del_g, combine_pair(a, b, del_g))
        del a, b

    a, b, del_g = tool.inputs()
    rows, ng = a.shape
    errs = _check_variants(a, b, del_g, combine_pair(a, b, del_g))
    presorted = is_sorted_along_g(a, b)
    pairs = (a[:, :, None] + b[:, None, :]).reshape(rows, ng * ng)
    padded = pairs.new_full((rows, ov.ref_pad(ng)), torch.finfo(a.dtype).max)
    padded[:, :ng * ng] = pairs
    library = {
        "sortonly": lambda: torch.topk(pairs, ng, largest=False),
        "rollonly": lambda: torch.roll(padded, ov.roll_shift(ng), dims=1),
    }
    records = {}
    for mode in ov.MODES:
        plain_ms = _cuda_ms(lambda: ov.combine_lean_plain(a, b, del_g, mode),
                            reps=2, warmup=1)
        bound_ms, bound_by = variant_bound_ms(mode, rows, ng, presorted)
        library_ms = (_cuda_ms(library[mode], reps=10) if mode in library
                      else None)
        records[mode] = dict(max_abs_err=errs[mode], plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms)
    del pairs, padded

    # the main path, counted on its own: the variants tool
    for mode in ov.MODES:
        ov.combine_lean.launches[mode] = 0
    times = tool.run(list(tool.NAMES), a, b, del_g)
    torch.cuda.synchronize()
    for mode, name in zip(ov.MODES, ("lean", "edges", "sortonly",
                                     "rollonly")):
        rec = records[mode]
        rec.update(ms=times[name], launches=ov.combine_lean.launches[mode])
        if rec["launches"] == 0:
            raise AssertionError(f"the tool did not launch {mode}")
        lib = ("" if rec["library_ms"] is None
               else f", library {rec['library_ms']:.4f} ms")
        _print(f"overlap_variants {mode}: {rec['ms']:.4f} ms per pair "
               f"(kernel 1: {times['current']:.4f}), plain "
               f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
               f"({rec['bound_by']}){lib}; {rec['launches']} launches")
    _print("overlap_variants full by rows per block: " + ", ".join(
        f"{t}: {times['lean' if t == ov.ROW_TILE else f'lean{t}']:.4f} ms"
        for t in ov.ROW_TILES))
    _print(f"the warp-per-row code's stages at R={rows}, NG={ng}: the merge "
           f"(sortonly) {times['sortonly']:.4f} ms, so its scan and rebin "
           f"{times['lean'] - times['sortonly']:.4f} ms (full - sortonly); "
           f"the walk rebin against the search rebin "
           f"{times['lean'] - times['edges']:+.4f} ms (full - edges); the "
           f"device-memory floor (rollonly) {times['rollonly']:.4f} ms")
    return records


def phase_sharded_lbl(profile: bool = False):
    """The LBL headline's synthesis as N_SHARDS logical wave shards through
    the packed entry, then the sharded LBL headline forward (the main
    path); returns the record."""
    import torch

    from archnemesis_tpu_torch.forward import (
        ATM_TO_PA,
        forward_nadir,
        runtime_ambient_fraction,
    )
    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.parallel.mesh import WaveMesh
    from archnemesis_tpu_torch.parallel.sharded import (
        shard_runtime_lbl,
        shard_spec,
        sharded_lbl_cross_section,
    )
    from archnemesis_tpu_torch.synthetic import LBL_NWAVE, lbl_headline

    atm, laycfg, rt, surf, cfg = lbl_headline(dtype=torch.float32,
                                              device="cuda")
    mesh = WaveMesh(n_data=1, n_wave=N_SHARDS)  # one process, no group
    rt_sh = shard_runtime_lbl(rt, mesh, dtype=torch.float32, device="cuda")
    sh, ll, blk = rt_sh.shard_data[0], rt.line_lists[0], rt.blocks[0]
    _, diag = forward_nadir(atm, laycfg, rt, None, None, surf, cfg,
                            emiss_ang=0.0, return_diagnostics=True,
                            device="cuda")
    layers = diag["layers"]
    state = (layers.temp, layers.press / ATM_TO_PA,
             runtime_ambient_fraction(cfg, layers, 0))
    host_state = [x.double().cpu().numpy() for x in state]

    k_sh = sharded_lbl_cross_section(ll, sh, mesh, *state)
    k_un = lbl_cuda.lbl_cross_section(ll, blk, *state)
    torch.cuda.synchronize()
    same = torch.equal(k_sh, k_un)
    _print(f"sharded synthesis ({N_SHARDS} shards) equals the unsharded "
           f"kernel bit for bit: {same} ({'ok' if same else 'FAIL'})")
    if not same:
        raise AssertionError("the sharded synthesis differs from kernel 2")
    specs = [shard_spec(ll, sh, s, packed=packed)
             for s, packed in zip(sh.shards, sh.packed)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = torch.cat([spec.plain(*state) for spec in specs])[:sh.n_wave]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (k_sh - plain).abs().max().item()
    _lbl_f32_check(k_sh, plain, f"sharded synthesis vs the plain version "
                   f"per shard, all {len(state[0])} layers")
    del plain

    shard_ms, bounds = [], []
    for s, spec in zip(sh.shards, specs):
        ms = _cuda_ms(lambda: lbl_cuda.lbl_kernel_packed(spec, *state),
                      reps=5)
        bound_ms, bound_by, ops = lbl_bound_ms(spec.ll, spec.blocks,
                                               *host_state, itemsize=4)
        shard_ms.append(ms)
        bounds.append((bound_ms, bound_by, ops))
        halo = int(sh.line_hi[s] - sh.line_lo[s])
        _print(f"shard {s}: waves {s * spec.blocks.n_wave}-"
               f"{(s + 1) * spec.blocks.n_wave - 1} (padded), lines "
               f"[{sh.line_lo[s]}, {sh.line_hi[s]}) = {halo} of "
               f"{ll.n_lines}; kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
               f"({bound_by}, {ops:.4e} operations)")
    total_ms = _cuda_ms(lambda: sharded_lbl_cross_section(ll, sh, mesh,
                                                          *state), reps=5)
    static = lbl_cuda.kernel_inputs(lbl_cuda.make_spec(ll, blk),
                                    state[0].dtype, state[0].device)
    packed = {(state[0].dtype, state[0].device): static}
    un_ms = _cuda_ms(lambda: lbl_cuda.lbl_cross_section(
        ll, blk, *state, packed=packed), reps=5)
    un_bound, _, un_ops = lbl_bound_ms(ll, blk, *host_state, itemsize=4)
    sh_ops = sum(o for _, _, o in bounds)
    bound_ms = sum(b for b, _, _ in bounds)
    pad_waves = sh.n_shards * sh.blocks_per_shard * sh.block_width - sh.n_wave
    _print(f"sharded synthesis: {N_SHARDS} launches, {total_ms:.4f} ms "
           f"({sum(shard_ms):.4f} ms over the launches timed one by one), "
           f"bound {bound_ms:.4f} ms ({sh_ops:.4e} operations); unsharded "
           f"kernel {un_ms:.4f} ms, bound {un_bound:.4f} ms ({un_ops:.4e}); "
           f"the halo and the {pad_waves} pad waves add {sh_ops - un_ops:.4e} "
           f"operations; plain {plain_ms:.1f} ms per shard in all")

    def forward(rt_run):
        return forward_nadir(atm, laycfg, rt_run, None, None, surf, cfg,
                             emiss_ang=0.0, device="cuda")

    # the main path, counted on its own
    lbl_cuda.lbl_kernel_packed.launches = 0
    spec_sh = forward(rt_sh)
    torch.cuda.synchronize()
    launches = lbl_cuda.lbl_kernel_packed.launches
    if launches != N_SHARDS:
        raise AssertionError(f"{launches} packed launches, expected "
                             f"{N_SHARDS}")
    spec_un = forward(rt)
    if spec_sh.shape != (LBL_NWAVE, 1) or not torch.isfinite(spec_sh).all():
        raise AssertionError("sharded LBL spectrum not finite")
    torch.testing.assert_close(spec_sh, spec_un, rtol=1e-6, atol=0)
    times = {}
    for name, rt_run in (("sharded", rt_sh), ("unsharded", rt),
                         ("sharded again", rt_sh)):
        t = []
        for i in range(HEADLINE_RUNS + 2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            forward(rt_run)
            end.record()
            end.synchronize()
            if i >= 2:
                t.append(start.elapsed_time(end))
        times[name] = float(np.median(t))
    _print(f"LBL headline forward, {N_SHARDS} wave shards in one process: "
           f"median {times['sharded']:.3f} / {times['sharded again']:.3f} ms "
           f"against {times['unsharded']:.3f} ms unsharded (spectra equal "
           f"{torch.equal(spec_sh, spec_un)}, within rtol 1e-6); "
           f"{launches} packed launches per forward")
    if profile:
        profile_forward(lambda: forward(rt_sh),
                        what="sharded LBL headline forward",
                        trace="build/lbl_sharded_trace.json")
    return dict(launches=launches, max_abs_err=err, ms=total_ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bounds[0][1], library_ms=None)


def phase_distributed():
    """The wave-sharded forward on the card through a one-rank NCCL group:
    jupiter_nadir (k-tables) and co_runtime (runtime LBL), sharded against
    unsharded; returns the packed launches of one runtime evaluation."""
    import torch
    import torch.distributed as dist

    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.parallel import multihost
    from archnemesis_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_ktables_by_wave,
    )
    from archnemesis_tpu_torch.parallel.sharded import shard_runtime_lbl
    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
    from archnemesis_tpu_torch.retrievals import make_retrieval_setup

    with tempfile.TemporaryDirectory() as tmp:
        rank = multihost.initialize(init_method=f"file://{tmp}/store",
                                    world_size=1, rank=0)
        try:
            backend = dist.get_backend()
            mesh = make_mesh(n_wave=N_SHARDS)
            if (rank, backend, mesh.world) != (0, "nccl", 1) or (
                    mesh.group is None):
                raise AssertionError(f"rank {rank}, backend {backend}")
            plain = make_retrieval_setup(DECK, "cirstest", device="cuda",
                                         wave_pad_multiple=N_SHARDS)
            sharded = make_retrieval_setup(
                DECK, "cirstest", device="cuda", wave_pad_multiple=N_SHARDS,
                ktab_transform=lambda kt: shard_ktables_by_wave(kt, mesh))
            xa = torch.as_tensor(plain.sv.xa, device="cuda")
            y0, y1 = plain.forward_fn(xa), sharded.forward_fn(xa)
            np.testing.assert_allclose(
                y1.cpu().numpy(), y0.cpu().numpy(), rtol=1e-12,
                atol=1e-14 * y0.abs().max().item())
            nx = xa.shape[0]
            basis = torch.eye(nx, dtype=xa.dtype,
                              device="cuda")[[0, nx // 2, nx - 1]]

            def columns(fn):
                return torch.func.vmap(
                    lambda v: torch.func.jvp(fn, (xa,), (v,))[1])(basis)

            j0, j1 = columns(plain.forward_fn), columns(sharded.forward_fn)
            np.testing.assert_allclose(
                j1.cpu().numpy(), j0.cpu().numpy(), rtol=1e-10,
                atol=1e-12 * j0.abs().max().item())
            _print(f"jupiter_nadir float64 over {N_SHARDS} wave shards "
                   f"({backend} group of {mesh.world}, file:// store; NY = "
                   f"{y0.shape[0]}): forward equal to unsharded at rtol "
                   f"1e-12, 3 Jacobian columns at rtol 1e-10 (max diff "
                   f"{(y1 - y0).abs().max().item():.3e} / "
                   f"{(j1 - j0).abs().max().item():.3e})")

            deck = copy_runtime_deck(os.path.join(tmp, "co"))
            rt_plain = make_retrieval_setup(deck, "cirstest", device="cuda")
            rt_sharded = make_retrieval_setup(
                deck, "cirstest", device="cuda",
                ktab_transform=lambda rt: shard_runtime_lbl(
                    rt, mesh, dtype=torch.float64, device="cuda"))
            xr = torch.as_tensor(rt_plain.sv.xa, device="cuda")
            yn0, kk0 = forward_and_jacobian(rt_plain.forward_fn, xr)
            lbl_cuda.lbl_kernel_packed.launches = 0
            yn1, kk1 = forward_and_jacobian(rt_sharded.forward_fn, xr)
            torch.cuda.synchronize()
            launches = lbl_cuda.lbl_kernel_packed.launches
            if launches != N_SHARDS:
                raise AssertionError(f"{launches} packed launches per "
                                     f"evaluation, expected {N_SHARDS}")
            np.testing.assert_allclose(yn1.cpu().numpy(), yn0.cpu().numpy(),
                                       rtol=1e-12, atol=0)
            col_peak = kk0.abs().max(dim=0).values
            np.testing.assert_array_less(
                (kk1 - kk0).abs().cpu().numpy(),
                (1e-10 * kk0.abs() + 1e-10 * col_peak[None, :]).cpu().numpy()
                + np.finfo(np.float64).tiny)
            _print(f"co_runtime float64, runtime deck over {N_SHARDS} wave "
                   f"shards through the group: spectrum equal to unsharded "
                   f"at rtol 1e-12, Jacobian ({kk1.shape[1]} columns) at rtol "
                   f"1e-10 + 1e-10 of each column's peak; {launches} packed "
                   "launches per evaluation")
        finally:
            dist.destroy_process_group()
    return launches


# ---- the scattering slice ---------------------------------------------------

SCAT_CORE_GOLDEN = "tests/goldens/scatter_core.npz"
SURF_GOLDEN = "tests/goldens/surface_singlescat.npz"
SCAT_DECK = "tests/fixtures/jupiter_scatter"
SCAT_FM_GOLDEN = "tests/goldens/jupiter_scatter_fm.npz"
SINGLE_FM_GOLDEN = "tests/goldens/jupiter_singlescat_fm.npz"
BRDF_FM_GOLDEN = "tests/goldens/jupiter_brdf_fm.npz"
SCAT_CORE_CASES = (("RAD_thermal", False, False), ("RAD_sun", True, False),
                   ("RAD_surface_sun", True, True))
BRDF_CASES = (("ms_lambert", 1, False), ("ms_hapke", 2, False),
              ("ss_hapke", 2, True), ("ss_orennayar", 3, True))
# float32 against float64 of the scattering paths: the JAX package's float32
# scattering bound (tests/test_scattering.py:117-121), relative to the peak
SCAT_F32_BOUND = 5.0e-4
# forward-plus-Jacobian runs of the scattering retrieval (~5 s each on the
# card, host-bound)
SCAT_JACOBIAN_RUNS = 3


def peak_rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def scatter_core_case(d, solar_on: bool, surface: bool, dtype, device):
    """``rt.scattering.scloud11wave`` on one case of the scatter_core golden
    (one HG mode + Rayleigh, NF=2; a Lambert 0.3 surface when asked)."""
    import torch

    from archnemesis_tpu_torch.rt import scattering as sc

    quad = sc.ScatterQuadrature(mu=tuple(d["MU"]), wtmu=tuple(d["WTMU"]),
                                nf=int(d["NF"]), nphi=int(d["NPHI"]))
    nwave = d["vwaves"].shape[0]

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    f, g1, g2 = (t(d[k], torch.float64)[:, None, None, None]
                 for k in ("f", "g1", "g2"))
    brdf = None
    if surface:
        brdf = np.zeros((nwave, quad.nmu, quad.nmu, quad.nf + 1))
        brdf[..., 0] = 0.3 / np.pi
        brdf = t(brdf)
    return sc.scloud11wave(
        quad, [lambda c: sc.henyey_greenstein2(c[None], f, g1, g2)],
        radg=t(d["radg"]), sol_ang=d["SOL_ANGS"], emiss_ang=d["EMISS_ANGS"],
        azi_ang=d["APHIS"],
        solar=t(d["solar"] if solar_on else np.zeros(nwave)),
        bnu=t(d["bnu"]), taus=t(d["taus"]), tauray=t(d["tauray"]),
        tauscat=t(d["tauscat_aero"]), lfrac=t(d["lfrac"]), iray=True,
        brdf_matrix=brdf)


def scatter_deck(device, dtype):
    """The Jupiter scattering deck read with the port's readers, its
    k-tables cut to the goldens' 60 waves, cast to ``dtype`` on
    ``device``."""
    import dataclasses

    import torch

    from archnemesis_tpu_torch.io.legacy import load_deck
    from archnemesis_tpu_torch.retrievals import (
        _attach_logk,
        _deck_to,
        cast_deck_components,
    )

    wave = np.load(SCAT_FM_GOLDEN)["WAVE"]
    deck = load_deck(SCAT_DECK, "cirstest")
    kt = deck.ktables
    kw = kt.wave.numpy()
    sel = torch.as_tensor(np.where((kw >= wave.min()) & (kw <= wave.max()))[0])
    deck = dataclasses.replace(deck, ktables=kt.replace(wave=kt.wave[sel],
                                                        k=kt.k[:, sel]))
    deck = cast_deck_components(_attach_logk(deck, dtype), dtype)
    return _deck_to(deck, device)


def scatter_deck_forward(deck, single: bool, device, surf=None,
                         gasgiant=None):
    """(spectrum (NWAVE, 1), diagnostics) of the deck's first FOV point by
    multiple or single scattering."""
    from archnemesis_tpu_torch.forward import (
        forward_scattering_nadir,
        forward_singlescat_nadir,
        make_forward_config,
    )
    from archnemesis_tpu_torch.rt.scattering import ScatterQuadrature

    st, g = deck.settings, deck.geometry
    surf = deck.surface if surf is None else surf
    cfg = make_forward_config(
        deck.atmosphere, deck.ktables, deck.cia, iray=st.iray,
        ispace=st.ispace,
        gasgiant=deck.surface.gasgiant if gasgiant is None else gasgiant)
    args = (deck.atmosphere, deck.layer_config, deck.ktables, deck.cia,
            deck.aerosol, surf, deck.stellar, cfg)
    kw = dict(emiss_ang=g.emiss_ang[0, 0], sol_ang=g.sol_ang[0, 0],
              azi_ang=g.azi_ang[0, 0], iray_phase=st.iray > 0,
              return_diagnostics=True, device=device)
    if single:
        return forward_singlescat_nadir(*args, deck.hgphase, **kw)
    quad = ScatterQuadrature(mu=st.mu, wtmu=st.wtmu, nf=st.nf, nphi=st.nphi)
    return forward_scattering_nadir(*args, quad, deck.hgphase, **kw)


def speconv_of(golden, spec):
    """The spectrum interpolated to the golden's channels."""
    from archnemesis_tpu_torch.ops.convolution import conv_channel_interp

    nconv = int(golden["NCONV"][0])
    vconv = spec.new_tensor(golden["VCONV"][:nconv, 0])
    wave = spec.new_tensor(golden["WAVE"])
    out = conv_channel_interp(wave, spec[:, 0], vconv)
    return out.double().cpu().numpy(), golden, nconv


def brdf_surface(deck, d, lowbc: int):
    """The synthetic surface of ``jupiter_brdf_fm`` (Lambert, Hapke or
    Oren-Nayar) on the deck's device and type."""
    from archnemesis_tpu_torch.core.spectra import HapkeParams
    from archnemesis_tpu_torch.enums import LowerBoundaryCondition

    like = deck.surface.vem

    def t(x):
        return like.new_tensor(np.asarray(x, dtype=np.float64))

    names = dict(sglalb="SGLALB", k="K", bs0="BS0", hs="hs", bc0="BC0",
                 hc="hc", roughness="ROUGHNESS", g1="G1", g2="G2", f="F")
    hapke = HapkeParams(vem=t(d["VEM"]), **{
        n: t(np.full(2, float(d["HAPKE_" + k]))) for n, k in names.items()})
    return deck.surface.replace(
        tsurf=t(float(d["TSURF"])), vem=t(d["VEM"]),
        emissivity=t(np.full(2, float(d["EMISS"]))),
        galb=t(float(d["GALB"])),
        hapke=hapke if lowbc == 2 else None,
        on_albedo=t(np.full(2, float(d["ON_ALB"]))) if lowbc == 3 else None,
        on_roughness=(t(np.full(2, float(d["ON_ROUGH"]))) if lowbc == 3
                      else None),
        lowbc=LowerBoundaryCondition(lowbc), gasgiant=False)


def phase_scattering_goldens():
    """The scattering goldens on the card in float64 at the JAX tests'
    bounds; float32 within ``SCAT_F32_BOUND`` of float64."""
    import torch

    from archnemesis_tpu_torch.rt import surface as surf_mod
    from archnemesis_tpu_torch.rt.singlescat import (
        single_scatter_plane_spectrum,
    )

    dev = "cuda"
    d = np.load(SCAT_CORE_GOLDEN)
    for key, solar_on, surface in SCAT_CORE_CASES:
        got = scatter_core_case(d, solar_on, surface, torch.float64, dev)
        got = got.cpu().numpy()
        np.testing.assert_allclose(got, d[key], rtol=1e-10, atol=0)
        got32 = scatter_core_case(d, solar_on, surface, torch.float32, dev)
        e32 = peak_rel(got32.cpu().numpy(), got)
        _print(f"scatter_core {key}: float64 max rel err vs golden "
               f"{np.abs(got / d[key] - 1).max():.3e} (bound 1e-10); "
               f"float32 vs float64 {e32:.3e} of peak")
        if not e32 < SCAT_F32_BOUND:
            raise AssertionError(f"float32 scatter_core {key} {e32:.3e}")

    ds = np.load(SURF_GOLDEN)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)

    hap = surf_mod.hapke_brdf(*(t(ds[k]) for k in (
        "W", "K", "BS0", "HS", "BC0", "HC", "ROUGH", "G1", "G2", "F", "SOL",
        "EMI", "AZI"))).cpu().numpy()
    np.testing.assert_allclose(hap, ds["HAPKE"], rtol=1e-10, atol=1e-14)
    oren = surf_mod.oren_nayar_brdf(*(t(ds[k]) for k in (
        "ALB", "ON_ROUGH", "SOL", "EMI", "AZI"))).cpu().numpy()
    np.testing.assert_allclose(oren, ds["OREN"], rtol=1e-10, atol=1e-14)
    lam = surf_mod.lambert_brdf(t(ds["ALB"]), 4).cpu().numpy()
    np.testing.assert_allclose(lam[:, 0], ds["ALB"] / np.pi, rtol=1e-12)
    ss_err = []
    for key, tsurf in (("SS_nosurf", -1.0), ("SS_surf", 290.0)):
        got = single_scatter_plane_spectrum(
            t(ds["WAVE"]), t(ds["TAU"]), t(ds["EMTEMP"]), t(ds["OMEGA"]),
            t(ds["PHASE"]), np.ones(ds["EMTEMP"].shape[0]), tsurf,
            t(ds["EMISSIVITY"]), t(ds["BRDF_PATH"]), t(ds["SOLAR"]), 35.0,
            20.0, ispace=0).cpu().numpy()
        np.testing.assert_allclose(got, ds[key], rtol=1e-10, atol=0)
        ss_err.append(np.abs(got / ds[key] - 1).max())
    _print(f"surface_singlescat float64: Hapke {peak_rel(hap, ds['HAPKE']):.3e}"
           f", Oren-Nayar {peak_rel(oren, ds['OREN']):.3e} of peak, single "
           f"scattering {max(ss_err):.3e} max rel (bounds 1e-10)")

    deck64 = scatter_deck(dev, torch.float64)
    spec, diag = scatter_deck_forward(deck64, False, dev)
    fm = np.load(SCAT_FM_GOLDEN)
    for name in ("taugas", "taucia", "tauray", "taudust", "tauscat",
                 "tautot"):
        want = fm[name.upper()]
        np.testing.assert_allclose(
            diag[name].cpu().numpy(), want, rtol=1e-5,
            atol=1e-12 * max(np.abs(want).max(), 1e-30), err_msg=name)
    got, _, nconv = speconv_of(fm, spec)
    want = fm["SPECONV"][:nconv, 0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    ms_err = np.abs(got / want - 1).max()
    sspec, _ = scatter_deck_forward(deck64, True, dev)
    ss = np.load(SINGLE_FM_GOLDEN)
    sgot, _, nconv = speconv_of(ss, sspec)
    np.testing.assert_allclose(sgot, ss["SPECONV"][:nconv, 0], rtol=1e-6,
                               atol=0)
    _print(f"jupiter_scatter_fm float64: layer taus within rtol 1e-5, "
           f"SPECONV max rel {ms_err:.3e} (bound 1e-6); "
           f"jupiter_singlescat_fm SPECONV max rel "
           f"{np.abs(sgot / ss['SPECONV'][:nconv, 0] - 1).max():.3e}")

    bd = np.load(BRDF_FM_GOLDEN)
    for key, lowbc, single in BRDF_CASES:
        bspec, _ = scatter_deck_forward(deck64, single, dev,
                                        surf=brdf_surface(deck64, bd, lowbc),
                                        gasgiant=False)
        bgot, _, nconv = speconv_of(bd, bspec)
        want = bd[key][:nconv, 0]
        np.testing.assert_allclose(bgot, want, rtol=1e-5,
                                   atol=np.abs(want).max() * 1e-8)
        _print(f"jupiter_brdf_fm {key} float64: max rel "
               f"{np.abs(bgot / want - 1).max():.3e} (bound 1e-5)")

    deck32 = scatter_deck(dev, torch.float32)
    for single, ref in ((False, spec), (True, sspec)):
        s32, _ = scatter_deck_forward(deck32, single, dev)
        e32 = peak_rel(s32.cpu().numpy(), ref.cpu().numpy())
        _print(f"jupiter_scatter {'single' if single else 'multiple'} "
               f"scattering float32 vs float64: {e32:.3e} of peak")
        if not e32 < SCAT_F32_BOUND:
            raise AssertionError("float32 scattering deck outside 5e-4")


SCATTER_COUNTERS = {"hansen": "scatter.hansen_reads",
                    "ladder": "scatter.ladder_reads",
                    "tiles": "scatter.tiles"}


def scatter_counts(before=None) -> dict:
    """The scattering core's counters (``utils/profiling.counters``:
    Hansen sweeps, ladder bounds, wave tiles), less ``before``'s."""
    from archnemesis_tpu_torch.utils.profiling import counters

    return {k: counters[name] - (before or {}).get(k, 0)
            for k, name in SCATTER_COUNTERS.items()}


def _scattering_forward(case, tile=None):
    import dataclasses

    from archnemesis_tpu_torch.forward import forward_scattering_nadir

    cfg = case["cfg"]
    if tile is not None:
        cfg = dataclasses.replace(cfg, scat_wave_tile=tile)
    return forward_scattering_nadir(**{**case, "cfg": cfg}, device="cuda")


def _time_forward(forward, runs: int) -> tuple:
    """(median ms over ``runs`` calls after two warm-ups, min, max, peak
    GiB); CUDA events around each call."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(runs + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        forward()
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**30
    return float(np.median(times)), min(times), max(times), peak


def phase_scattering_headline(profile: bool = False):
    """bench.py's scattering workload at full width through the port's
    forward; returns the primal kernel's launches in one forward."""
    import torch

    from archnemesis_tpu_torch.ops.overlap_cuda import combine_pair
    from archnemesis_tpu_torch.synthetic import (
        SCAT_NWAVE,
        scattering_headline,
    )

    case = scattering_headline(torch.float32, "cuda")
    # the main path, counted on its own
    combine_pair.launches = 0
    before = scatter_counts()
    spec = _scattering_forward(case)
    torch.cuda.synchronize()
    launches = combine_pair.launches
    reads = scatter_counts(before)
    if launches != 6:
        raise AssertionError(f"{launches} kernel launches, expected 6")
    tiles = -(-SCAT_NWAVE // case["cfg"].scat_wave_tile)
    if not reads["tiles"] == reads["ladder"] == tiles:
        raise AssertionError(f"{reads}: one ladder bound a tile, {tiles} "
                             "tiles expected")
    if spec.shape != (SCAT_NWAVE, 1) or not torch.isfinite(spec).all():
        raise AssertionError("scattering headline spectrum not finite")
    spec64 = _scattering_forward(scattering_headline(torch.float64, "cuda"))
    e32 = peak_rel(spec.cpu().numpy(), spec64.cpu().numpy())
    r = rel_err(spec.double().cpu().numpy(), spec64.cpu().numpy())
    _print(f"scattering headline (2048 waves x 10 g x 39 layers x 7 gases, "
           f"NMU=5, NF=2, NPHI=100, 2 HG modes, Rayleigh, solar): "
           f"{launches} launches of kernel 1; host reads per forward: "
           f"{reads['hansen']} Hansen sweeps, {reads['ladder']} ladder "
           f"bounds over {reads['tiles']} wave tiles; float32 vs float64 "
           f"{e32:.3e} of peak, max rel {r.max():.3e}")
    if not e32 < SCAT_F32_BOUND:
        raise AssertionError("float32 scattering headline outside 5e-4")
    del spec64

    out = {}
    for tile in (case["cfg"].scat_wave_tile, SCAT_NWAVE):
        before = combine_pair.launches
        ms, lo, hi, peak = _time_forward(
            lambda: _scattering_forward(case, tile), HEADLINE_RUNS)
        if combine_pair.launches - before != 6 * (HEADLINE_RUNS + 2):
            raise AssertionError("launches did not rise by 6 per forward")
        out[tile] = _scattering_forward(case, tile)
        _print(f"scattering headline float32, wave tile {tile}: median "
               f"{ms:.3f} ms over {HEADLINE_RUNS} runs (min {lo:.3f}, max "
               f"{hi:.3f}); {SCAT_NWAVE / ms * 1e3:.1f} waves/s; peak memory "
               f"{peak:.3f} GiB")
    a, b = out.values()
    e_tile = peak_rel(a.cpu().numpy(), b.cpu().numpy())
    _print(f"wave tile 128 vs one 2048-wave tile: {e_tile:.3e} of peak")
    if not e_tile < SCAT_F32_BOUND:
        raise AssertionError("the two tile sizes disagree")
    del out, a, b

    # a real deck's quadrature order (NMU 10-21 in the reference's decks)
    c15 = scattering_headline(torch.float32, "cuda", nmu=15)
    s15 = {}
    for name, cc in (("float32", c15),
                     ("float64", scattering_headline(torch.float64, "cuda",
                                                     nmu=15))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s15[name] = _scattering_forward(cc)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not torch.isfinite(s15[name]).all():
            raise AssertionError(f"NMU=15 {name} not finite")
        _print(f"scattering headline NMU=15 {name}, wave tile 128: one "
               f"forward {wall:.3f} ms wall; peak memory {peak:.3f} GiB")
    e15 = peak_rel(s15["float32"].cpu().numpy(), s15["float64"].cpu().numpy())
    _print(f"NMU=15 float32 vs float64: {e15:.3e} of peak")
    if not e15 < SCAT_F32_BOUND:
        raise AssertionError("NMU=15 float32 outside 5e-4 of float64")
    del s15, c15
    if profile:
        for tile in (case["cfg"].scat_wave_tile, SCAT_NWAVE):
            profile_forward(lambda: _scattering_forward(case, tile), runs=1,
                            what=f"scattering headline forward (float32, "
                                 f"tile {tile})",
                            trace=f"build/scattering{tile}_trace.json")
    return launches, e32


def jacobian_column_misses(k32, k64, entries) -> tuple:
    """(error of each float32 Jacobian column against float64 over the
    column's float64 peak (0 for a column that float32 cannot hold, see
    ``float32_unheld_columns``), [(model id, column, error, column peak
    over the largest column peak)] of the columns at or above
    ``JAC_F32_BOUND``)."""
    import torch

    col_peak = k64.abs().max(dim=0).values
    live = col_peak >= torch.finfo(torch.float32).tiny
    col_err = torch.where(
        live, (k32.double() - k64).abs().max(dim=0).values
        / torch.where(live, col_peak, 1.0), 0.0).cpu().numpy()
    rel_peak = (col_peak / col_peak.max()).cpu().numpy()
    owner = {c: e.model_id for e in entries
             for c in range(e.ix, e.ix + e.nx)}
    misses = [(owner[c], c, float(f"{col_err[c]:.4g}"),
               float(f"{rel_peak[c]:.3g}"))
              for c in range(col_err.shape[0]) if col_err[c] >= JAC_F32_BOUND]
    return col_err, misses


def float32_unheld_columns(k64) -> list:
    """The nonzero columns of a float64 Jacobian whose peak lies below
    float32's smallest normal number (1.2e-38): float32 holds no value of
    theirs (on jupiter_limb the columns of the levels under the lowest
    tangent, 1e-42 to 1e-129 of the largest column's peak)."""
    import torch

    col_peak = k64.abs().max(dim=0).values
    unheld = (col_peak > 0) & (col_peak < torch.finfo(torch.float32).tiny)
    return torch.nonzero(unheld).flatten().tolist()


def phase_scattering_retrieval(profile: bool = False):
    """The scattering retrieval (jupiter_scatter: models 0, 47, 444) through
    the port's entry points on the card; returns the fused kernel's
    launches in one forward-plus-Jacobian evaluation."""
    import torch

    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
    from archnemesis_tpu_torch.retrievals import (
        make_retrieval_setup,
        retrieval_nemesis,
    )

    s64 = make_retrieval_setup(SCAT_DECK, "cirstest", device="cuda")
    cpu = make_retrieval_setup(SCAT_DECK, "cirstest", device="cpu")
    xa = torch.as_tensor(s64.sv.xa, device="cuda")
    y_card = s64.forward_fn(xa).cpu().numpy()
    y_cpu = cpu.forward_fn(cpu.sv.xa).numpy()
    np.testing.assert_allclose(y_card, y_cpu, rtol=1e-9, atol=0)
    nx, ny = s64.sv.nx, s64.y.shape[0]
    e444 = next(e for e in s64.sv.entries if e.model_id == 444)
    j = e444.ix + 2
    tangent = torch.zeros(nx, dtype=torch.float64, device="cuda")
    tangent[j] = 1.0
    _, dy = torch.func.jvp(s64.forward_fn, (xa,), (tangent,))

    # the main path of this phase, counted on its own: one
    # forward-plus-Jacobian evaluation, all tangents in one pass
    before = scatter_counts()
    (yn, kk), launches = _fused_launches(
        lambda: forward_and_jacobian(s64.forward_fn, xa))
    reads = scatter_counts(before)
    if launches != 6:
        raise AssertionError(f"{launches} fused launches, expected 6")
    if kk.shape != (ny, nx) or not torch.isfinite(kk).all():
        raise AssertionError(f"Jacobian not finite ({ny}, {nx})")
    for e in s64.sv.entries:
        if not kk[:, e.ix:e.ix + e.nx].abs().max() > 0.0:
            raise AssertionError(f"model {e.model_id}'s columns are zero")
    np.testing.assert_allclose(
        kk[:, j].cpu().numpy(), dy.cpu().numpy(), rtol=1e-10,
        atol=1e-12 * dy.abs().max().item())
    _print(f"jupiter_scatter float64 on the card (NX={nx}, NY={ny}; models "
           f"0, 47, 444): forward_fn(xa) within rtol 1e-9 of the CPU (max "
           f"rel {np.abs(y_card / y_cpu - 1).max():.3e}); every Jacobian "
           "column finite, each model's columns nonzero, column "
           f"{j} equal to its JVP; {launches} fused launches per evaluation; "
           f"host reads per evaluation: {reads['hansen']} Hansen sweeps, "
           f"{reads['ladder']} ladder bounds")

    s32 = make_retrieval_setup(SCAT_DECK, "cirstest", device="cuda",
                               dtype=torch.float32)
    results = {}
    for name, setup, x in (("float64", s64, xa), ("float32", s32, xa.float())):
        forward_and_jacobian(setup.forward_fn, x)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(SCAT_JACOBIAN_RUNS):
            t0 = time.perf_counter()
            res, launched = _fused_launches(
                lambda: forward_and_jacobian(setup.forward_fn, x))
            times.append((time.perf_counter() - t0) * 1e3)
            if launched != 6:
                raise AssertionError(f"{launched} fused launches ({name})")
        peak = torch.cuda.max_memory_allocated() / 2**30
        results[name] = res
        _print(f"forward-plus-Jacobian on jupiter_scatter ({nx} tangents, "
               f"{name}): median {np.median(times):.3f} ms over {len(times)} "
               f"runs (min {min(times):.3f}, max {max(times):.3f}); peak "
               f"memory {peak:.3f} GiB")
    (y64, k64), (y32, k32) = results["float64"], results["float32"]
    e_y = peak_rel(y32.cpu().numpy(), y64.cpu().numpy())
    col_err, misses = jacobian_column_misses(k32, k64, s64.sv.entries)
    _print(f"scattering retrieval float32 vs float64: spectrum {e_y:.3e} of "
           f"peak; Jacobian max error over column peak {col_err.max():.3e} "
           f"(gate {JAC_F32_BOUND:.0e}); columns outside the gate (model, "
           f"column, error, column peak over the largest): "
           f"{misses if misses else 'none'}")
    for e in s64.sv.entries:
        worst = int(np.argmax(col_err[e.ix:e.ix + e.nx])) + e.ix
        _print(f"  model {e.model_id} (columns {e.ix}..{e.ix + e.nx - 1}): "
               f"worst column {worst}, error {col_err[worst]:.3e}")
    if not e_y < SCAT_F32_BOUND:
        raise AssertionError("float32 scattering retrieval outside 5e-4")
    if misses:
        raise AssertionError(f"float32 scattering Jacobian columns outside "
                             f"{JAC_F32_BOUND:.0e} of their peaks: {misses}")
    results.clear()

    with tempfile.TemporaryDirectory() as tmp:
        deck = copy_deck(SCAT_DECK, tmp)
        t0 = time.perf_counter()
        res3, launched = _fused_launches(lambda: retrieval_nemesis(
            deck, "cirstest", niter=3, write_outputs=False, device="cuda"))
        wall = time.perf_counter() - t0
    hist = res3.phi_history
    if not (np.isfinite(res3.xn).all() and np.isfinite(hist).all()
            and hist[-1] <= hist[0]):
        raise AssertionError("scattering retrieval did not keep phi finite "
                             "and non-increasing")
    _print(f"retrieval_nemesis(jupiter_scatter, niter=3, float64): "
           f"{wall:.3f} s wall, {res3.n_iter} iterations accepted, "
           f"{launched} fused launches, phi {['%.6e' % p for p in hist]}")
    if profile:
        profile_forward(
            lambda: forward_and_jacobian(s64.forward_fn, xa), runs=1,
            what=f"scattering forward-plus-Jacobian (float64, {nx} tangents)",
            trace="build/scattering_jacobian_trace.json")
    return launches



# ---- the remaining models: profile, spectral, measurement, ILS, optics ---

MODELS_FIXTURES = "tests/fixtures/models"
MODELS_APPLY_GOLDEN = "tests/goldens/models_apply.npz"
MODELS_DOMAIN_GOLDEN = "tests/goldens/models_domain.npz"
MODELS_EXO_GOLDEN = "tests/goldens/models_exo_venus.npz"
ILS_GOLDEN = "tests/goldens/ils_models.npz"
# the blocks of tests/fixtures/models appended to the jupiter_nadir deck's
# own temperature block (model 0) in the models_nadir case
MODELS_NADIR_BLOCKS = ("m1_knee", "m2_scale", "m3_logscale", "m45_ch4",
                       "m9_cloud", "m887_xsc", "m447_doppler", "m231_poly",
                       "m667_dilution")
# the models_ils case: the channels kept (cm-1), the .spx FWHM (< 0: the
# ILS comes from the state) and model 229's a priori and errors (main
# Gaussian offsets A0, A1, A2 and the second Gaussian's DELDG [cm-1], FWHM
# at the first channel [cm-1], the second Gaussian's amplitude at both
# ends). 229's FWHM grows with the square of the wavenumber, 4.7-fold over
# 600-1300 cm-1 (8 to 37.6 cm-1, 3 to 15 calc points of 2.5 cm-1), and the
# widened calc range 454-1446 cm-1 stays inside the k-tables' 5-1500 cm-1;
# over the deck's whole 5-1399 cm-1 it would grow 78,000-fold and the range
# would leave the tables below 5 cm-1
MODELS_ILS_CHANNELS = (600.0, 1300.0)
MODELS_ILS_FWHM = -1.0
MODELS_ILS_229 = ((0.2, 0.1), (-0.1, 0.1), (0.15, 0.1), (3.0, 0.5),
                  (8.0, 1.0), (0.3, 0.05), (0.2, 0.05))
# the profile goldens of tests/test_models.py (parse and apply_state), and
# the two applied directly (the reference's wrappers of 9 and 49 are broken
# upstream, so their goldens come from direct calculate calls)
PROFILE_CASES = ("m0_temp", "m1_knee", "m2_scale", "m3_logscale",
                 "m4_kneevar", "m20_kneetrop", "m32_cloudp", "m45_ch4",
                 "m47_gauss", "m50_scaleprof", "m51_setprof", "mm1_aeroprof")
DOMAIN_CASES = ("m999_tsurf", "m777_tanhe", "m666_ptan", "m887_xsc",
                "m231_poly", "m232_angstrom", "m233_quad", "m667_dilution")
ILS_RTOL = 5.0e-4  # tests/test_ils_models.py: the interpolation limit
MODELS_EVAL_RUNS = 5


def _model_atmosphere(device):
    """jupiter_nadir's deck (port reader) with its atmosphere on ``device``."""
    from archnemesis_tpu_torch.io.legacy import load_deck

    deck = load_deck(DECK, "cirstest")
    return deck, deck.atmosphere.to(device)


def _apr_case(d, name, atm):
    """Parse a fixture .apr and hold XA/SA/LX to golden ``d`` at the JAX
    tests' tolerances; returns the state vector."""
    from archnemesis_tpu_torch.retrieval.statevector import read_apr

    sv = read_apr(f"{MODELS_FIXTURES}/{name}/test.apr", atm)
    np.testing.assert_allclose(sv.xa, d[f"{name}_XA"], rtol=1e-10,
                               err_msg=name)
    np.testing.assert_allclose(sv.sa, d[f"{name}_SA"], rtol=1e-8, atol=1e-30,
                               err_msg=name)
    np.testing.assert_array_equal(sv.lx, d[f"{name}_LX"], err_msg=name)
    return sv


def _np(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


def _profile_case(name, device):
    import torch

    from archnemesis_tpu_torch.models import MODEL_REGISTRY
    from archnemesis_tpu_torch.retrieval.statevector import apply_state

    d = np.load(MODELS_APPLY_GOLDEN)
    _, atm = _model_atmosphere(device)
    sv = _apr_case(d, name, atm)
    if name == "m9_cloud":
        x = np.array([np.exp(sv.xa[0]), np.exp(sv.xa[1]), sv.xa[2]])
        out = MODEL_REGISTRY[9].apply(sv.entries[0], atm,
                                      torch.as_tensor(x, device=device))
        np.testing.assert_allclose(_np(out.dust), d["m9_cloud_DUST"],
                                   rtol=1e-8, atol=1e-38)
        return
    if name == "m49_refgas":
        out = MODEL_REGISTRY[49].apply(
            sv.entries[0], atm, torch.as_tensor(np.exp(sv.xa), device=device))
        np.testing.assert_allclose(_np(out.vmr), d["m49_refgas_VMR"],
                                   rtol=1e-10)
        return
    out = apply_state(atm, torch.as_tensor(sv.xa, device=device), sv)
    np.testing.assert_allclose(_np(out.t), d[f"{name}_T"], rtol=1e-8,
                               err_msg=f"{name} T")
    np.testing.assert_allclose(_np(out.vmr), d[f"{name}_VMR"], rtol=1e-8,
                               atol=1e-40, err_msg=f"{name} VMR")
    np.testing.assert_allclose(_np(out.dust), d[f"{name}_DUST"], rtol=1e-7,
                               atol=1e-38, err_msg=f"{name} DUST")
    np.testing.assert_allclose(_np(out.h), d[f"{name}_H"], rtol=1e-7,
                               atol=1e-3, err_msg=f"{name} H")
    renorm = d[f"{name}_RENORM"]
    if renorm.max() > 0:
        np.testing.assert_allclose(_np(out.dust_renorm), renorm, rtol=1e-10)


def _domain_case(name, device):
    import torch

    from archnemesis_tpu_torch.retrieval.statevector import (
        apply_domain,
        apply_spectrum_models,
        apply_state,
    )

    d = np.load(MODELS_DOMAIN_GOLDEN)
    deck, atm = _model_atmosphere(device)
    sv = _apr_case(d, name, atm)
    xa = torch.as_tensor(sv.xa, device=device)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                               device=device)

    nconv = int(deck.geometry.nconv[0])
    if name == "m999_tsurf":
        surf = apply_domain(sv, xa, "surface", deck.surface.to(device))
        np.testing.assert_allclose(float(surf.tsurf),
                                   float(d["m999_tsurf_TSURF"]))
    elif name == "m777_tanhe":
        ms = apply_domain(sv, xa, "measurement", {})
        np.testing.assert_allclose(12.0 + float(ms["tanhe_shift"]),
                                   d["m777_tanhe_TANHE"][0])
    elif name == "m666_ptan":
        out = apply_state(atm, xa, sv, adjust_hydrostat=False)
        np.testing.assert_allclose(_np(out.p), d["m666_ptan_P"], rtol=1e-8)
    elif name == "m887_xsc":
        aero = apply_domain(sv, xa, "scatter", deck.aerosol.to(device))
        np.testing.assert_allclose(_np(aero.kext), d["m887_xsc_KEXT"],
                                   rtol=1e-10)
    elif name in ("m231_poly", "m667_dilution"):
        got = apply_spectrum_models(sv, xa, 0, t(d["VCONV"][:nconv, 0]),
                                    t(d["SPECMOD_IN"][:nconv, 0]))
        np.testing.assert_allclose(_np(got), d[f"{name}_SPECMOD"][:nconv, 0],
                                   rtol=1e-10)
    else:  # m232_angstrom, m233_quad
        got = apply_spectrum_models(sv, xa, 0, t(d[f"{name}_WAVEC"]),
                                    t(d[f"{name}_SPEC_IN"]))
        np.testing.assert_allclose(_np(got), d[f"{name}_SPECMOD"],
                                   rtol=1e-10)


def venus_atmosphere(device):
    """The 40-level Venus atmosphere of tests/test_models_exo_venus.py."""
    from archnemesis_tpu_torch.core.types import Atmosphere

    npro = 40
    h = np.linspace(0.0, 90.0e3, npro)
    arrays = dict(
        h=h, p=9.2e6 * np.exp(-h / 15.9e3),
        t=np.linspace(730.0, 170.0, npro),
        vmr=np.stack([np.full(npro, 0.965), np.full(npro, 1.5e-4)], axis=1),
        dust=np.zeros((npro, 4)), parah2=np.zeros(npro),
        molwt=np.full(npro, 43.45e-3), radius=np.asarray(6.0518e6),
        latitude=np.asarray(0.0))
    import torch

    return Atmosphere(
        **{k: torch.as_tensor(v, device=device) for k, v in arrays.items()},
        gas_id=(2, 9), iso_id=(0, 0), planet=2)


def _exo_case(name, device):
    import io

    import torch

    from archnemesis_tpu_torch.models import MODEL_REGISTRY
    from archnemesis_tpu_torch.models.base import ModelEntry, ProfileTarget
    from archnemesis_tpu_torch.retrieval.statevector import apply_domain

    d = np.load(MODELS_EXO_GOLDEN)
    _, atm = _model_atmosphere(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=device)

    if name == "m43_guillot":
        apr = io.StringIO(
            "0.3 0.05\n0.8 0.1\n1.0e-3 2e-4\n0.2 0.05\n2.0 0.4\n"
            "5700.0 6.96e8 7.78e11 150.0\n")
        ctx = dict(npro=atm.np_, gas_id=atm.gas_id, iso_id=atm.iso_id,
                   ndust=atm.ndust)
        res = MODEL_REGISTRY[43].from_apr(apr, [0, 0, 43], 0, ctx)
        out = MODEL_REGISTRY[43].apply(res.entry, atm,
                                       t([0.3, 0.8, 1.0e-3, 0.2, 2.0]))
        np.testing.assert_allclose(_np(out.t), d["m43_T"], rtol=1e-7)
    elif name == "m62_madhu":
        sv = _apr_case(d, name, atm)
        x = np.where(sv.lx == 1, np.exp(sv.xa), sv.xa)
        out = MODEL_REGISTRY[62].apply(sv.entries[0], atm, t(x))
        np.testing.assert_allclose(_np(out.t), d["m62_T"], rtol=1e-10)
    elif name == "m447_doppler":
        sv = _apr_case(d, name, atm)
        ms = apply_domain(sv, t(sv.xa), "measurement", {})
        np.testing.assert_allclose(float(ms["v_doppler"]), 3.5)
    else:  # m110_venus, m111_venus
        venus = venus_atmosphere(device)
        mid = 110 if name == "m110_venus" else 111
        e = ModelEntry(varident=(-1, 0, mid), model_id=mid, ix=0,
                       nx=1 if mid == 110 else 3,
                       target=ProfileTarget.AEROSOL, target_idx=0,
                       extra=() if mid == 110 else (1,))
        x = [2.5] if mid == 110 else [-1.5, 1.0e-4, 5.0e-6]
        out = MODEL_REGISTRY[mid].apply(e, venus, t(x))
        np.testing.assert_allclose(_np(out.dust), d[f"m{mid}_DUST"],
                                   rtol=1e-10, atol=1e-30)
        if mid == 111:
            np.testing.assert_allclose(_np(out.vmr), d["m111_VMR"],
                                       rtol=1e-10)


def model_entry(model_id, nx, extra=()):
    """A ModelEntry of ``model_id`` that targets no profile (the entries of
    the ILS, optics and spectral models), at the start of the state."""
    from archnemesis_tpu_torch.models.base import ModelEntry, ProfileTarget

    return ModelEntry(
        varident=(model_id, 0, model_id), model_id=model_id, ix=0, nx=nx,
        target=ProfileTarget.NOT_ATMOSPHERIC, extra=extra)


def ils_model_spectrum(model_id, x, device, d=None):
    """(vconv', convolved spectrum) of ILS model 228, 229 or 230 on the
    golden's grid, spectrum and parameters ``x`` (a tensor)."""
    import torch

    from archnemesis_tpu_torch.models import MODEL_REGISTRY
    from archnemesis_tpu_torch.ops.convolution import (
        apply_ils,
        double_gauss_ils_weights,
    )

    d = np.load(ILS_GOLDEN) if d is None else d
    nx, extra = {228: (8, ()), 229: (7, ())}.get(model_id, (14, None))
    if model_id == 230:
        lims = tuple((float(lo), float(hi))
                     for lo, hi in zip(d["LIML"], d["LIMH"]))
        extra = (2, lims)
    vc, off, fw, amp = MODEL_REGISTRY[model_id].apply_ils(
        model_entry(model_id, nx, extra), 0,
        torch.as_tensor(d["VCONV"], device=device), x)
    w = double_gauss_ils_weights(d["WAVE"], vc, off, fw, amp)
    return vc, apply_ils(w, torch.as_tensor(d["SPEC"], device=device))


def ils_parameters(model_id, d):
    """Model ``model_id``'s parameters in the ILS golden (230: window-major,
    7 per window)."""
    return {228: d["P228"], 229: d["P229"],
            230: d["PAR230"].T.reshape(-1)}[model_id]


def _ils_case(name, device):
    import torch

    d = np.load(ILS_GOLDEN)
    mid = int(name[1:4])
    x = torch.as_tensor(ils_parameters(mid, d), device=device)
    vc, y = ils_model_spectrum(mid, x, device, d)
    if mid == 228:
        np.testing.assert_allclose(_np(vc), d["VCONV228"], rtol=1e-12)
    np.testing.assert_allclose(_np(y), d[f"Y{mid}"], rtol=ILS_RTOL)
    if mid == 229:
        jac = torch.func.jacfwd(
            lambda p: ils_model_spectrum(229, p, device, d)[1])(x)
        if not (torch.isfinite(jac).all() and jac.abs().max() > 0):
            raise AssertionError("model 229's Jacobian is not finite or is 0")


def model446_lookup():
    """(entry extras, aerosol waves, radius) of the in-memory size lookup
    of tests/test_optics_models.py (no HDF5 file)."""
    rng = np.random.default_rng(11)
    wave_lu = np.linspace(800.0, 1400.0, 25)
    reff = np.array([0.1, 0.5, 1.0, 2.0, 5.0])
    kext_lu = rng.uniform(0.5, 2.0, (25, 5)).cumsum(axis=1)
    alb_lu = rng.uniform(0.2, 0.9, (25, 5))
    return ((1, 1, 1000.0, wave_lu, reff, kext_lu, alb_lu),
            np.linspace(850.0, 1350.0, 40))


def model500_cia(device):
    """The CIA table of tests/test_optics_models.py's model 500 case."""
    import torch

    from archnemesis_tpu_torch.core.spectra import CIATables
    from archnemesis_tpu_torch.enums import ParaH2Ratio

    arrays = dict(waven=np.linspace(0.0, 2000.0, 201),
                  temp=np.array([100.0, 200.0]), frac=np.array([0.25]),
                  k_cia=np.full((2, 1, 2, 201), 7.0))
    return CIATables(
        **{k: torch.as_tensor(v, device=device) for k, v in arrays.items()},
        pair_gas1=(39, 39), pair_gas2=(39, 40), inormalt=(None, None),
        npara=0, inormal=ParaH2Ratio.EQUILIBRIUM)


def _optics_case(name, device):
    import torch
    from scipy.interpolate import interp1d

    from archnemesis_tpu_torch.core.spectra import AerosolOptics
    from archnemesis_tpu_torch.models import MODEL_REGISTRY

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=device)

    if name == "m446_lookup":
        extra, aero_wave = model446_lookup()
        _, _, xwave, wave_lu, reff, kext_lu, alb_lu = extra
        aero = AerosolOptics(wave=t(aero_wave), kext=t(np.ones((40, 2))),
                             ksca=t(np.ones((40, 2))))
        k1 = interp1d(wave_lu, kext_lu, axis=0)(aero_wave)
        a1 = interp1d(wave_lu, alb_lu, axis=0)(aero_wave)
        for r, r_table in ((0.73, 0.73), (99.0, 5.0)):  # and clamped
            out = MODEL_REGISTRY[446].apply_scatter(
                model_entry(446, 1, extra), aero, t([r]))
            kx = interp1d(reff, k1, axis=1)(r_table)
            ax = interp1d(reff, a1, axis=1)(r_table)
            kx = kx / np.interp(xwave, aero_wave, kx)
            np.testing.assert_allclose(_np(out.kext)[:, 1], kx, rtol=1e-10)
            np.testing.assert_allclose(_np(out.ksca)[:, 1], ax * kx,
                                       rtol=1e-10)
    else:  # m500_basis: the reference formula (model_500.py:79-95)
        nbasis, amps = 5, np.array([2.0, 1.0, 3.0, 0.5, 1.5])
        out = MODEL_REGISTRY[500].apply_cia(
            model_entry(500, nbasis, (1,)), model500_cia(device), t(amps),
            wave_range=(400.0, 1600.0))
        k = _np(out.k_cia)
        ilo, ihi = 40, 160
        width = (ihi - ilo) / nbasis
        centers = np.linspace(ilo, ihi, nbasis)
        xs = np.arange(ilo, ihi + 1)
        g = np.exp(-((xs[:, None] - centers[None, :]) ** 2)
                   / (2 * width**2))
        expect = g @ (amps * 1e-40)
        assert np.all(k[0] == 0.0)
        for it in range(2):
            np.testing.assert_allclose(k[1, 0, it, ilo:ihi + 1], expect,
                                       rtol=1e-12)
        assert np.all(k[1, 0, 0, :ilo] == 0.0)
        assert np.all(k[1, 0, 0, ihi + 1:] == 0.0)


def _radius_case(name, device):
    """Models 555/556 (tests/test_models_domain.py: the override is
    honoured for a catalogue planet)."""
    import io

    import torch

    from archnemesis_tpu_torch.models import MODEL_REGISTRY

    _, atm = _model_atmosphere(device)
    res = MODEL_REGISTRY[555].from_apr(io.StringIO("5.0 1.0\n"),
                                       [555, 0, 555], 0, {})
    a1 = MODEL_REGISTRY[555].apply(
        res.entry, atm, torch.tensor([5.0], dtype=torch.float64,
                                     device=device))
    res = MODEL_REGISTRY[556].from_apr(io.StringIO("1.01 0.005\n"),
                                       [556, 0, 556], 0, {})
    a2 = MODEL_REGISTRY[556].apply(
        res.entry, atm, torch.tensor([1.01], dtype=torch.float64,
                                     device=device))
    np.testing.assert_allclose(float(a2.planet_radius) / 1.01,
                               float(a1.planet_radius) - 5.0e3, rtol=1e-10)


def knee_profile_loop(atm, abu_deep, fsh, pknee_atm):
    """The JAX package's level scan of the knee profile (models 1, 4, 20;
    ``archnemesis_tpu/models/profile_models.py:_knee_profile``) as a loop
    over the levels: the reference that ``models.profile_models.
    _knee_profile``, a closed form, is held to, and whose operations the
    models phase counts beside it."""
    import torch

    from archnemesis_tpu_torch.models import profile_models as pm

    xfac = (1.0 - fsh) / fsh
    pknee_pa = pknee_atm * 101325.0
    hknee = pm._hknee_from_p(atm, pknee_pa)
    scale = pm._atm_scale_height(atm)
    h_prev = torch.cat([atm.h[:1], atm.h[:-1]])
    prev, seen, out = atm.h.new_zeros(()), False, []
    for j in range(atm.h.shape[0]):
        delh = atm.h[j] - h_prev[j] if seen else atm.h[j] - hknee
        above = bool(atm.p[j] < pknee_pa)
        val = (pm._maximum(prev * torch.exp(-delh * xfac / scale[j]), 1e-36)
               if above else abu_deep)
        seen = seen or above
        out.append(val)
        prev = val
    return torch.stack(out)


def model9_loop(atm, x):
    """Model 9's cloud (``archnemesis_tpu/models/profile_models.py:545``)
    with the JAX package's level scan as a loop over the levels, beside
    the closed form of ``models.profile_models.Model9``; returns the
    normalised profile."""
    import torch

    from archnemesis_tpu_torch.models import profile_models as pm

    tau, xfsh, hknee = x[0], x[1], x[2]
    scale = pm._atm_scale_height(atm)
    h_km = atm.h / 1.0e3
    delh = torch.cat([atm.h.new_zeros(1), torch.diff(atm.h)])
    prev, seen, out = atm.h.new_zeros(()), False, []
    for j in range(atm.h.shape[0]):
        above = bool(h_km[j] >= hknee)
        if above and not seen:
            val = torch.ones_like(prev)
        elif above:
            val = prev * torch.exp(-delh[j] / (scale[j] * xfsh))
        else:
            val = torch.zeros_like(prev)
        seen = seen or above
        out.append(val)
        prev = val
    nd = torch.stack(out)
    h_next = torch.cat([h_km[1:], h_km[-1:] + 1.0])
    frac = 1.0 - (hknee - h_km) * 1.0e3 / ((h_next - h_km) * 1.0e3)
    nd = torch.where(h_km < hknee,
                     torch.where(h_next >= hknee, nd * frac, 0.0), nd)
    return nd / pm.simpson_nonuniform(nd, atm.h) * tau


def model_golden_cases() -> dict:
    """name -> check(device): every model golden of the JAX package's model
    tests, on the port. Each raises if the port misses the golden at the
    JAX test's own tolerance."""
    cases = {n: _profile_case
             for n in PROFILE_CASES + ("m9_cloud", "m49_refgas")}
    cases.update({n: _domain_case for n in DOMAIN_CASES})
    cases.update({n: _exo_case for n in ("m43_guillot", "m62_madhu",
                                         "m447_doppler", "m110_venus",
                                         "m111_venus")})
    cases.update({n: _ils_case for n in ("m228_ils", "m229_ils",
                                         "m230_ils")})
    cases.update({n: _optics_case for n in ("m446_lookup", "m500_basis")})
    cases["m555_m556_radius"] = _radius_case
    return {name: (lambda device, fn=fn, name=name: fn(name, device))
            for name, fn in cases.items()}


def _apr_block(name: str) -> str:
    """A fixture's model block: its .apr after the header and count."""
    with open(f"{MODELS_FIXTURES}/{name}/test.apr") as f:
        return "".join(f.readlines()[2:])


def _write_apr(deck: str, blocks) -> None:
    """The deck's cirstest.apr: its own temperature block (model 0), then
    ``blocks``."""
    apr = os.path.join(deck, "cirstest.apr")
    with open(apr) as f:
        own = f.readlines()[2:4]
    with open(apr, "w") as f:
        f.write("*** jupiter_nadir with the remaining models ***\n")
        f.write(f"{1 + len(blocks)}\n")
        f.write("".join(own))
        for block in blocks:
            f.write(block if block.endswith("\n") else block + "\n")


def models_nadir_deck(base: str) -> str:
    """A copy of jupiter_nadir under ``base`` whose .apr holds model 0
    (temperature, 81 levels) and the fixture blocks of
    ``MODELS_NADIR_BLOCKS``: a knee profile (NH3), a scaling (gas 26) and a
    log scaling (gas 27), the CH4 humidity model, a cloud (dust 1), the
    cross sections of model 887, a retrieved Doppler shift (447), a
    polynomial scaling (231, with its scal231.dat) and a dilution (667).
    Its .xsc is rewritten on 887's six wavelengths with 887's a-priori
    cross sections and albedo 0, so that the cloud absorbs."""
    deck = copy_deck(DECK, base)
    _write_apr(deck, [_apr_block(n) for n in MODELS_NADIR_BLOCKS])
    shutil.copy(f"{MODELS_FIXTURES}/m231_poly/scal231.dat", deck)
    with open(f"{MODELS_FIXTURES}/m887_xsc/test.apr") as f:
        rows = [line.split() for line in f.readlines()[4:]]
    with open(os.path.join(deck, "cirstest.xsc"), "w") as f:
        f.write("1\n")
        for wave, xsc, _err in rows:
            f.write(f"{wave}  {xsc}\n       0.0\n")
    return deck


def models_ils_deck(base: str) -> str:
    """A copy of jupiter_nadir under ``base`` with its channels cut to
    ``MODELS_ILS_CHANNELS``, its .spx FWHM set below 0 and an .apr of model
    0, the double-Gaussian ILS of model 229 (a priori ``MODELS_ILS_229``)
    and a retrieved Doppler shift (447): the set-up's "dynamic" ILS with a
    moving observer-frame grid."""
    deck = copy_deck(DECK, base)
    spx = os.path.join(deck, "cirstest.spx")
    with open(spx) as f:
        lines = f.readlines()
    lo, hi = MODELS_ILS_CHANNELS
    rows = [r for r in lines[4:] if r.split()
            and lo <= float(r.split()[0]) <= hi]
    head = lines[0].split()
    with open(spx, "w") as f:
        f.write(f"{MODELS_ILS_FWHM:12.4f} {' '.join(head[1:])}\n")
        f.write(f"{len(rows):11d}\n")
        f.write("".join(lines[2:4]) + "".join(rows))
    block229 = "229 0 229\n" + "".join(f"{v} {e}\n"
                                       for v, e in MODELS_ILS_229)
    _write_apr(deck, [block229, _apr_block("m447_doppler")])
    return deck



def _count_ops(fn):
    """(fn(), the tensor operations it dispatched): on the card each is at
    least one kernel launch, so the count is the launches the host issues
    (the kernels' own ctypes launches are counted by their wrappers)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with _Count() as count:
        out = fn()
    return out, count.n


def _cpu_jacobian_columns(setup, cols, chunk: int = 12):
    """Columns ``cols`` of a CPU set-up's Jacobian at its a priori, as
    (NY, len(cols)) float64: ``chunk`` tangents per ``vmap`` of ``jvp``."""
    import torch

    x = torch.as_tensor(setup.sv.xa)
    parts = []
    for i in range(0, len(cols), chunk):
        part = cols[i:i + chunk]
        basis = torch.zeros(len(part), setup.sv.nx, dtype=torch.float64)
        basis[torch.arange(len(part)), torch.as_tensor(part)] = 1.0
        _, dy = torch.func.vmap(
            lambda v: torch.func.jvp(setup.forward_fn, (x,), (v,)),
            out_dims=(None, 0))(basis)
        parts.append(dy)
    return torch.cat(parts).T


def _time_evaluations(setup, x, runs: int):
    """(median, min, max ms, peak GiB) of ``forward_and_jacobian`` over
    ``runs`` runs after a warm-up, host clock ending in a synchronise,
    each run checked to launch the fused kernel 6 times."""
    import torch

    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian

    forward_and_jacobian(setup.forward_fn, x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        _, launched = _fused_launches(
            lambda: forward_and_jacobian(setup.forward_fn, x))
        times.append((time.perf_counter() - t0) * 1e3)
        if launched != 6:
            raise AssertionError(f"{launched} fused launches, expected 6")
    return (float(np.median(times)), min(times), max(times),
            torch.cuda.max_memory_allocated() / 2**30)


def _models_case(name: str, deck: str, card: str, profile: bool = False):
    """One composed deck on the card: the float64 forward and full Jacobian
    against the port's CPU set-up, float32 against float64, the launches
    and the time of an evaluation. Returns (primal launches of one
    forward, fused launches of one evaluation)."""
    import torch

    from archnemesis_tpu_torch.ops.overlap_cuda import combine_pair
    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
    from archnemesis_tpu_torch.retrievals import make_retrieval_setup

    s64 = make_retrieval_setup(deck, "cirstest", device="cuda")
    cpu = make_retrieval_setup(deck, "cirstest", device="cpu")
    nx, ny = s64.sv.nx, s64.y.shape[0]
    xa = torch.as_tensor(s64.sv.xa, device="cuda")

    # the main path of this case, counted on its own: one forward (kernel 1)
    # and one forward-plus-Jacobian evaluation (kernel 1t)
    combine_pair.launches = 0
    y_card = s64.forward_fn(xa)
    torch.cuda.synchronize()
    primal = combine_pair.launches
    if primal != 6:
        raise AssertionError(f"{name}: {primal} primal launches, expected 6")
    (yn, kk), fused, emission = _jacobian_launches(
        lambda: forward_and_jacobian(s64.forward_fn, xa))
    if (fused, emission) != (6, 1):
        raise AssertionError(f"{name}: {fused} fused and {emission} emission "
                             "tangent launches, expected 6 and 1")
    if kk.shape != (ny, nx) or not torch.isfinite(kk).all():
        raise AssertionError(f"{name}: Jacobian not finite ({ny}, {nx})")
    torch.testing.assert_close(yn, y_card, rtol=1e-12, atol=0)

    # float64 on the card against the port's CPU run of the same set-up:
    # every column of the new models, and model 0's levels 0, 40 and 80
    # (phase 6 holds model 0's columns to the reference)
    y_cpu = cpu.forward_fn(cpu.sv.xa).numpy()
    y64 = y_card.cpu().numpy()
    np.testing.assert_allclose(y64, y_cpu, rtol=1e-10, atol=0)
    cols = [c for e in s64.sv.entries if e.model_id != 0
            for c in range(e.ix, e.ix + e.nx)]
    cols += [c for e in s64.sv.entries if e.model_id == 0
             for c in range(e.ix, e.ix + e.nx, 40)]
    t0 = time.perf_counter()
    k_cpu = _cpu_jacobian_columns(cpu, cols).numpy()
    cpu_s = time.perf_counter() - t0
    k_card = kk.cpu().numpy()
    worst = 0.0
    for i, c in enumerate(cols):
        peak = np.abs(k_cpu[:, i]).max()
        np.testing.assert_allclose(k_card[:, c], k_cpu[:, i], rtol=0,
                                   atol=1e-8 * peak,
                                   err_msg=f"{name} column {c}")
        if peak > 0:
            worst = max(worst, np.abs(k_card[:, c] - k_cpu[:, i]).max() / peak)
    models = sorted({e.model_id for e in s64.sv.entries})
    _print(f"{name} float64 on the card (NX={nx}, NY={ny}; models "
           f"{models}): forward within rtol 1e-10 of the CPU (max rel "
           f"{np.abs(y64 / y_cpu - 1).max():.3e}); {len(cols)} Jacobian "
           f"columns within 1e-8 of their peaks (worst {worst:.3e}; the "
           f"CPU's columns took {cpu_s:.1f} s); {primal} primal launches per "
           f"forward, {fused} fused and {emission} emission tangent launches "
           f"per evaluation")

    # float32 against float64, at PERF.md's gates
    s32 = make_retrieval_setup(deck, "cirstest", device="cuda",
                               dtype=torch.float32)
    (y32, k32), fused32 = _fused_launches(
        lambda: forward_and_jacobian(s32.forward_fn, xa.float()))
    if fused32 != 6:
        raise AssertionError(f"{name}: {fused32} fused launches (float32)")
    r = rel_err(y32.double().cpu().numpy(), y64)
    col_err, misses = jacobian_column_misses(k32, kk, s64.sv.entries)
    _print(f"{name} float32 vs float64: spectrum max rel {r.max():.3e}, "
           f"median {np.median(r):.3e} (gate {F32_BOUNDS[0]:.0e}); Jacobian "
           f"max error over column peak {col_err.max():.3e} (gate "
           f"{JAC_F32_BOUND:.0e}); columns outside the gate (model, column, "
           f"error, column peak over the largest): "
           f"{misses if misses else 'none'}")
    if not r.max() < F32_BOUNDS[0]:
        raise AssertionError(f"{name}: float32 spectrum outside 1e-4")
    if misses:
        raise AssertionError(f"{name}: float32 Jacobian columns outside "
                             f"{JAC_F32_BOUND:.0e} of their peaks: {misses}")
    del y32, k32

    # the time, memory and host operations of one evaluation
    for dtype_name, setup, x in (("float64", s64, xa),
                                 ("float32", s32, xa.float())):
        med, lo, hi, peak_gib = _time_evaluations(setup, x, MODELS_EVAL_RUNS)
        _, ops_fwd = _count_ops(lambda: setup.forward_fn(x))
        _, ops_jac = _count_ops(
            lambda: forward_and_jacobian(setup.forward_fn, x))
        _print(f"forward-plus-Jacobian on {name} (NX={nx}, {dtype_name}, "
               f"{card}): median {med:.3f} ms over {MODELS_EVAL_RUNS} runs "
               f"(min {lo:.3f}, max {hi:.3f}); peak memory {peak_gib:.3f} "
               f"GiB; tensor operations dispatched: {ops_fwd} per forward, "
               f"{ops_jac} per evaluation")
    if profile:
        profile_forward(
            lambda: forward_and_jacobian(s64.forward_fn, xa), runs=1,
            what=f"{name} forward-plus-Jacobian (float64, {nx} tangents)",
            trace=f"build/{name}_jacobian_trace.json")
    return primal, fused


def _recurrence_forms():
    """The closed forms of the knee profile and of model 9 against their
    level loops on the jupiter_nadir atmosphere (81 levels, float64) at
    rtol 1e-12, and the tensor operations each form dispatches in a forward
    and in a ``jacfwd`` over its three parameters."""
    import torch

    from archnemesis_tpu_torch.models import profile_models as pm
    from archnemesis_tpu_torch.models.base import ModelEntry, ProfileTarget

    _, atm = _model_atmosphere("cuda")
    cloud = ModelEntry(varident=(-1, 0, 9), model_id=9, ix=0, nx=3,
                       target=ProfileTarget.AEROSOL, target_idx=0)
    forms = {
        "knee profile (models 1/4/20)": (
            lambda z: pm._knee_profile(atm, z[0], z[1], z[2]),
            lambda z: knee_profile_loop(atm, z[0], z[1], z[2]),
            [1.9e-4, 0.3, 0.5]),
        "model 9": (
            lambda z: pm.Model9.apply(cloud, atm, z).dust[:, 0],
            lambda z: model9_loop(atm, z), [4.0, 0.25, -20.0]),
    }
    for what, (closed, loop, x0) in forms.items():
        x = torch.tensor(x0, dtype=torch.float64, device="cuda")
        got, ops_closed = _count_ops(lambda: closed(x))
        want, ops_loop = _count_ops(lambda: loop(x))
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
        _, jac_closed = _count_ops(lambda: torch.func.jacfwd(closed)(x))
        _print(f"{what} on {atm.np_} levels: the closed form equal to the "
               f"level loop within rtol 1e-12; tensor operations "
               f"{ops_closed} a forward and {jac_closed} a jacfwd over its 3 "
               f"parameters, the loop {ops_loop} a forward")


def phase_models(card: str, profile: bool = False):
    """The remaining models on the card: every model golden in float64, the
    composed ``models_nadir`` and ``models_ils`` decks through the
    retrieval set-up, and a 3-iteration retrieval on ``models_nadir``.
    Returns (primal launches, fused launches) of the two cases' main
    paths."""
    import torch

    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
    from archnemesis_tpu_torch.retrievals import (
        make_retrieval_setup,
        retrieval_nemesis,
    )

    t0 = time.perf_counter()
    cases = model_golden_cases()
    for check in cases.values():
        check("cuda")
    torch.cuda.synchronize()
    _print(f"model goldens on the card, float64: {len(cases)} cases "
           f"({', '.join(cases)}) at the JAX tests' tolerances, in "
           f"{time.perf_counter() - t0:.1f} s")
    _recurrence_forms()

    # the operations the deck's own state vector (model 0 alone) makes,
    # beside which the composed decks' counts are read
    plain = make_retrieval_setup(DECK, "cirstest", device="cuda")
    xp = torch.as_tensor(plain.sv.xa, device="cuda")
    forward_and_jacobian(plain.forward_fn, xp)
    _, ops_fwd = _count_ops(lambda: plain.forward_fn(xp))
    _, ops_jac = _count_ops(lambda: forward_and_jacobian(plain.forward_fn,
                                                         xp))
    _print(f"jupiter_nadir with model 0 alone (NX={plain.sv.nx}): tensor "
           f"operations dispatched: {ops_fwd} per forward, {ops_jac} per "
           "evaluation")
    del plain

    launches = np.zeros(2, dtype=int)
    with tempfile.TemporaryDirectory() as tmp:
        nadir = models_nadir_deck(os.path.join(tmp, "nadir"))
        launches += _models_case("models_nadir", nadir, card, profile)
        launches += _models_case("models_ils",
                                 models_ils_deck(os.path.join(tmp, "ils")),
                                 card)
        t0 = time.perf_counter()
        res3, launched = _fused_launches(lambda: retrieval_nemesis(
            nadir, "cirstest", niter=3, write_outputs=False, device="cuda"))
        wall = time.perf_counter() - t0
    hist = res3.phi_history
    if not (np.isfinite(res3.xn).all() and hist[-1] < hist[0]):
        raise AssertionError("models_nadir retrieval did not reduce phi")
    _print(f"retrieval_nemesis(models_nadir, niter=3, float64, {card}): "
           f"{wall:.3f} s wall, {res3.n_iter} iterations accepted, "
           f"{launched} fused launches, phi {['%.6e' % p for p in hist]}")
    return int(launches[0]), int(launches[1])



# --- phase 19: the limb, disc-averaged and combined geometries

LIMB_DECK = "tests/fixtures/jupiter_limb"
LIMB_GOLDEN = "tests/goldens/jupiter_limb_fm.npz"
DISC_GOLDEN = "tests/goldens/jupiter_disc_fm.npz"
# the limb columns held to the port's CPU run (1e-10 of their peaks) on
# the card: temperature levels inside the weighting functions
LIMB_JVP_COLUMNS = (20, 30, 45)
# the three angles of the combined multi-angle copy of jupiter_scatter
C_ANGLES = (10.0, 35.0, 60.0)
GEOM_EVAL_RUNS = 3


def blocks_deck(src: str, base: str, names) -> str:
    """A copy of the deck ``src`` under ``base`` whose .apr holds the model
    fixture blocks ``names`` (``tests/fixtures/models``) and nothing else:
    a state vector of a few elements, whose Jacobian fits the CPU."""
    deck = copy_deck(src, base)
    with open(os.path.join(deck, "cirstest.apr"), "w") as f:
        f.write(f"*** {os.path.basename(src)} with {', '.join(names)} ***\n")
        f.write(f"{len(names)}\n")
        f.write("".join(_apr_block(n) for n in names))
    return deck


def c_angle_deck(base: str, angles) -> str:
    """A copy of jupiter_scatter under ``base`` whose .spx holds one
    geometry per emission angle of ``angles`` (the deck's own channels,
    measurement and FOV point otherwise)."""
    deck = copy_deck(SCAT_DECK, base)
    spx = os.path.join(deck, "cirstest.spx")
    with open(spx) as f:
        lines = f.read().splitlines()
    head = lines[0].split()
    nconv = int(lines[1].split()[0])
    fov = lines[3].split()
    rows = lines[4:4 + nconv]
    out = [" ".join(head[:3] + [str(len(angles))])]
    for ang in angles:
        fov[3] = f"{float(ang):.5f}"
        out += [lines[1], lines[2], " ".join(fov)] + rows
    with open(spx, "w") as f:
        f.write("\n".join(out) + "\n")
    return deck


def _primal_launches(fn):
    """(result of fn(), kernel-1 launches it made), counted from 0."""
    import torch

    from archnemesis_tpu_torch.ops.overlap_cuda import combine_pair

    combine_pair.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, combine_pair.launches


def _geometry_launches(name: str, setup, x):
    """The main path of a geometry, counted on its own: one forward (kernel
    1) and one forward-plus-Jacobian evaluation (kernel 1t), each exactly
    6 launches. Returns (y, (yn, kk), primal, fused, emission tangent
    launches of the evaluation)."""
    import torch

    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian

    y, primal = _primal_launches(lambda: setup.forward_fn(x))
    if primal != 6:
        raise AssertionError(f"{name}: {primal} primal launches, expected 6")
    yk, fused, emission = _jacobian_launches(
        lambda: forward_and_jacobian(setup.forward_fn, x))
    if fused != 6:
        raise AssertionError(f"{name}: {fused} fused launches, expected 6")
    if not torch.isfinite(yk[1]).all():
        raise AssertionError(f"{name}: Jacobian not finite")
    torch.testing.assert_close(yk[0], y, rtol=1e-12, atol=0)
    return y, yk, primal, fused, emission


def _limb_case(card: str):
    """jupiter_limb as committed through ``make_retrieval_setup_limb`` on
    the card. Returns (primal launches of one forward, fused launches of
    one evaluation)."""
    import torch

    from archnemesis_tpu_torch.retrievals import (
        make_retrieval_setup_limb,
        retrieval_nemesis,
    )

    s64 = make_retrieval_setup_limb(LIMB_DECK, "cirstest", device="cuda")
    cpu = make_retrieval_setup_limb(LIMB_DECK, "cirstest", device="cpu")
    nx, ny = s64.sv.nx, s64.y.shape[0]
    xa = torch.as_tensor(s64.sv.xa, device="cuda")
    y, (_, kk), primal, fused, emission = _geometry_launches("limb", s64,
                                                             xa)
    if emission != 1:
        raise AssertionError(f"limb: {emission} emission tangent launches, "
                             "expected 1")
    y64 = y.cpu().numpy()

    # the reference golden at tests/test_forward_limb.py's tolerances
    d = np.load(LIMB_GOLDEN)
    golden = np.asarray(d["SPECONV"])
    np.testing.assert_allclose(y64.reshape(len(d["TANHE"]), -1).T, golden,
                               rtol=2e-5,
                               atol=np.median(np.abs(golden)) * 1e-6)
    # the port's CPU run of the same set-up: forward and three columns
    y_cpu = cpu.forward_fn(cpu.sv.xa).numpy()
    np.testing.assert_allclose(y64, y_cpu, rtol=1e-10, atol=0)
    cols = list(LIMB_JVP_COLUMNS)
    k_cpu = _cpu_jacobian_columns(cpu, cols).numpy()
    k_card = kk.cpu().numpy()[:, cols]
    col_err = np.abs(k_card - k_cpu).max(axis=0) / np.abs(k_cpu).max(axis=0)
    if not col_err.max() < 1e-10:
        raise AssertionError(f"limb: Jacobian columns {cols} off the CPU "
                             f"by {col_err} of their peaks")
    _print(f"limb (jupiter_limb: NX={nx}, NY={ny}, 3 tangent heights on 6 "
           f"tangent paths of up to 126 layers) float64 on the card: "
           f"golden within rtol 2e-5 (max rel "
           f"{np.abs(y64.reshape(3, -1).T / golden - 1).max():.3e}); the "
           f"CPU's forward within 1e-10 (max rel "
           f"{np.abs(y64 / y_cpu - 1).max():.3e}); columns {cols} within "
           f"{col_err.max():.3e} of their peaks; {primal} primal launches "
           f"per forward, {fused} fused and {emission} emission tangent "
           f"launches per evaluation")

    s32 = make_retrieval_setup_limb(LIMB_DECK, "cirstest", device="cuda",
                                    dtype=torch.float32)
    y32, (_, k32), *_ = _geometry_launches("limb float32", s32,
                                           xa.float())
    r = rel_err(y32.double().cpu().numpy(), y64)
    col_err, misses = jacobian_column_misses(k32, kk, s64.sv.entries)
    _print(f"limb float32 vs float64: spectrum max rel {r.max():.3e}, "
           f"median {np.median(r):.3e} (gates {F32_BOUNDS[0]:.0e} / "
           f"{F32_BOUNDS[1]:.0e}); Jacobian max error over column peak "
           f"{col_err.max():.3e} (gate {JAC_F32_BOUND:.0e}); columns outside "
           f"the gate: {misses if misses else 'none'}; columns whose float64 "
           f"peak float32 cannot hold: {float32_unheld_columns(kk)}")
    if not (r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1]):
        raise AssertionError("limb: float32 spectrum outside 1e-4 / 1e-5")
    if misses:
        raise AssertionError(f"limb: float32 Jacobian columns outside "
                             f"{JAC_F32_BOUND:.0e} of their peaks: {misses}")
    del kk, k32
    for dtype_name, setup, x in (("float64", s64, xa),
                                 ("float32", s32, xa.float())):
        med, lo, hi, peak_gib = _time_evaluations(setup, x, GEOM_EVAL_RUNS)
        _print(f"forward-plus-Jacobian on jupiter_limb (NX={nx}, "
               f"{dtype_name}, {card}): median {med:.3f} ms over "
               f"{GEOM_EVAL_RUNS} runs (min {lo:.3f}, max {hi:.3f}); peak "
               f"memory {peak_gib:.3f} GiB")
    del s32
    with tempfile.TemporaryDirectory() as base:
        deck = copy_deck(LIMB_DECK, base)
        t0 = time.perf_counter()
        res = retrieval_nemesis(deck, "cirstest", niter=3, nemesis_l=True,
                                write_outputs=False, device="cuda")
        wall = time.perf_counter() - t0
    if not (np.all(np.isfinite(res.xn))
            and res.phi_history[-1] <= res.phi_history[0]):
        raise AssertionError(f"limb retrieval: phi {res.phi_history}")
    _print(f"retrieval_nemesis(nemesis_l=True, niter=3) on jupiter_limb "
           f"({card}): {wall:.3f} s, phi {res.phi_history[0]:.6e} -> "
           f"{res.phi_history[-1]:.6e}")
    return primal, fused


def _disc_case(card: str):
    """The disc set-up on jupiter_nadir on the card at nmu = 3 against the
    golden, its launches, and an evaluation at nmu = 3 and 5. Returns
    (primal launches of one forward, fused launches of one evaluation)."""
    import torch

    from archnemesis_tpu_torch.retrievals import make_retrieval_setup_disc

    launches = None
    for nmu in (3, 5):
        setup = make_retrieval_setup_disc(DECK, "cirstest", nmu=nmu,
                                          device="cuda")
        xa = torch.as_tensor(setup.sv.xa, device="cuda")
        y, _, primal, fused, emission = _geometry_launches(
            f"disc nmu={nmu}", setup, xa)
        if nmu == 3:
            d = np.load(DISC_GOLDEN)
            want = d["SPECONV"]
            np.testing.assert_allclose(y.cpu().numpy(), want, rtol=1e-5,
                                       atol=np.abs(want).max() * 1e-8)
            launches = (primal, fused)
            _print(f"disc nmu=3 (jupiter_nadir, 16 rays) float64 on the "
                   f"card: golden within rtol 1e-5 (max rel "
                   f"{np.abs(y.cpu().numpy() / want - 1).max():.3e}); "
                   f"{primal} primal launches per forward, {fused} fused "
                   f"and {emission} emission tangent launches (one a chunk "
                   f"of rays) per evaluation")
        med, lo, hi, peak_gib = _time_evaluations(setup, xa, GEOM_EVAL_RUNS)
        fwd = _time_forward_ms(lambda: setup.forward_fn(xa))
        _print(f"disc nmu={nmu} (NX={setup.sv.nx}, float64, {card}): "
               f"forward {fwd:.3f} ms; forward-plus-Jacobian median "
               f"{med:.3f} ms over {GEOM_EVAL_RUNS} runs (min {lo:.3f}, max "
               f"{hi:.3f}); peak memory {peak_gib:.3f} GiB")
        del setup
    return launches


def _time_forward_ms(fn, runs: int = 5) -> float:
    """Median host ms of ``fn()`` ending in a synchronise, after one
    warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _combined_case():
    """``make_retrieval_setup_c`` on the card: equal to the nadir set-up on
    jupiter_scatter, and a three-angle copy equal to three single-angle
    copies. Returns the primal launches of one forward."""
    import torch

    from archnemesis_tpu_torch.retrievals import (
        make_retrieval_setup,
        make_retrieval_setup_c,
    )

    sc = make_retrieval_setup_c(SCAT_DECK, "cirstest", device="cuda")
    sn = make_retrieval_setup(SCAT_DECK, "cirstest", device="cuda")
    xa = torch.as_tensor(sc.sv.xa, device="cuda")
    y_c, primal = _primal_launches(lambda: sc.forward_fn(xa))
    y_n = sn.forward_fn(xa)
    torch.testing.assert_close(y_c, y_n, rtol=1e-10, atol=0)
    with tempfile.TemporaryDirectory() as base:
        three = make_retrieval_setup_c(
            c_angle_deck(os.path.join(base, "all"), C_ANGLES), "cirstest",
            device="cuda")
        y3 = three.forward_fn(xa)
        singles = torch.cat([
            make_retrieval_setup_c(
                c_angle_deck(os.path.join(base, f"a{i}"), [ang]),
                "cirstest", device="cuda").forward_fn(xa)
            for i, ang in enumerate(C_ANGLES)])
    torch.testing.assert_close(y3, singles, rtol=1e-10, atol=0)
    _print(f"combined set-up on the card: jupiter_scatter equal to the nadir "
           f"set-up (max rel {rel_err(y_c.cpu().numpy(), y_n.cpu().numpy()).max():.3e}, "
           f"{primal} primal launches per forward); {len(C_ANGLES)} angles "
           f"{C_ANGLES} in one path batch equal to three single-angle "
           f"set-ups (max rel "
           f"{rel_err(y3.cpu().numpy(), singles.cpu().numpy()).max():.3e})")
    return primal


def phase_geometries(card: str):
    """Phase 19: the limb, disc-averaged and combined geometries on the
    card. Returns (kernel-1 launches, kernel-1t launches) of their main
    paths."""
    limb = _limb_case(card)
    disc = _disc_case(card)
    comb = _combined_case()
    return limb[0] + disc[0] + comb, limb[1] + disc[1]


# --- phase 20: nested sampling

NS_BATCHES = (64, 400)


def phase_nested(card: str):
    """Phase 20: nested sampling on the full jupiter_fdret on the card: the
    chunked batched likelihood against a loop of ``forward_fn``, the
    3-parameter posterior against OE (the JAX package's slow
    tests/test_nested_deck.py check), logZ, likelihood count and rate.
    Returns the kernel-1 launches of the main path (the sampler's run)."""
    import dataclasses

    import torch

    from archnemesis_tpu_torch.retrieval.nested import (
        STATE_CHUNK,
        batched_loglike,
        run_setup_ns,
        setup_loglike,
    )
    from archnemesis_tpu_torch.retrieval.oe import coreret_oe
    from archnemesis_tpu_torch.retrievals import make_retrieval_setup

    setup = make_retrieval_setup(FDRET, "cirstest", device="cuda")
    loglike, transform, ndim = setup_loglike(setup)
    u = np.random.default_rng(0).uniform(size=(max(NS_BATCHES), ndim))
    batched = batched_loglike(loglike, transform, device="cuda")
    for n in NS_BATCHES:
        t0 = time.perf_counter()
        got, primal = _primal_launches(lambda: batched(u[:n]))
        batch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = np.array([
            float(loglike(transform(torch.as_tensor(row, device="cuda"))))
            for row in u[:n]])
        loop_s = time.perf_counter() - t0
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
        chunks = -(-n // STATE_CHUNK)
        if primal != 6 * chunks:
            raise AssertionError(f"batched likelihood of {n}: {primal} "
                                 f"primal launches, expected {6 * chunks}")
        _print(f"batched likelihood, {n} states in chunks of {STATE_CHUNK} "
               f"({card}): "
               f"{batch_s:.3f} s ({primal} primal launches) against "
               f"{loop_s:.3f} s for a loop of forward_fn; equal within "
               f"1e-10 (max rel {np.abs(got / want - 1).max():.3e})")

    # the 3-parameter posterior against OE
    sv = setup.sv
    nx = sv.nx
    vary = np.zeros(nx, bool)
    vary[[2, nx // 2, nx - 3]] = True
    sa = np.asarray(sv.sa).copy()
    sa[:] = np.diag(np.where(vary, np.diag(sa), 1e-12))
    setup = dataclasses.replace(setup, sv=dataclasses.replace(sv, sa=sa))
    oe = coreret_oe(setup.forward_fn, sv.xa, sa, setup.y, setup.se, sv.lx,
                    niter=4, philimit=0.1, device="cuda")
    x_oe = np.asarray(oe.xn)
    s_oe = np.sqrt(np.diag(np.asarray(oe.st)))
    t0 = time.perf_counter()
    ns, launches = _primal_launches(lambda: run_setup_ns(
        setup, n_live=30, evidence_tolerance=0.5, seed=3, batch=30))
    wall = time.perf_counter() - t0
    sig = np.sqrt(np.diag(sa))
    tol = 2.0 * np.maximum(s_oe, sig)
    err = np.abs(ns.means - x_oe)
    y = np.asarray(setup.y)
    inv_e2 = 1.0 / np.diag(np.asarray(setup.se))

    def chi2(x):
        yn = setup.forward_fn(x).cpu().numpy()
        return float(np.sum((yn - y) ** 2 * inv_e2))

    best = ns.samples[np.argmax(ns.logl)]
    chi_ns, chi_oe = chi2(best), chi2(x_oe)
    _print(f"nested sampling on jupiter_fdret (3 of {nx} parameters, n_live "
           f"30, batch 30, {card}): logZ {ns.logz:.6f} +- "
           f"{ns.logz_err:.6f}, {ns.n_iter} iterations, {ns.n_like} "
           f"likelihoods in {wall:.3f} s ({ns.n_like / wall:.1f} per s, "
           f"{launches} primal launches); posterior means off OE by "
           f"{err[vary]} (2 sigma {tol[vary]}); best chi2 {chi_ns:.3f} "
           f"against OE's {chi_oe:.3f}")
    if not (np.isfinite(ns.logz) and np.all(err[vary] < tol[vary])
            and chi_ns < 3.0 * chi_oe + 1e-6):
        raise AssertionError("nested sampling: posterior off the OE result")
    return launches


# --- phase 21: solar occultation, AOTF, transit and the Titan FOV deck

SO_DECK = "tests/fixtures/mars_so"
SO_RUN = "mars_solocc"
# the .npz export of the deck's HDF5 run file (the card's machine has no
# h5py; tests/port_cases.write_deck_export writes it)
SO_EXPORT = "archnemesis_tpu_torch/data/mars_solocc.npz"
SO_GOLDEN = "tests/goldens/mars_so_fm.npz"
AOTF_GOLDEN = "tests/goldens/mars_so_aotf_fm.npz"
TRANSIT_GOLDEN = "tests/goldens/mars_transit_fm.npz"
TITAN_DECK = "tests/fixtures/titan_fov"
TITAN_GOLDEN = "tests/goldens/titan_fov_fm.npz"
# the Stellar group that tests/test_retrieval_transit.py adds to the SO
# deck to make it a transit run (RADIUS in km, as Stellar_0 stores it)
TRANSIT_STELLAR = dict(SOLEXIST=True, DIST=1.5, RADIUS=6.957e5, ISPACE=0,
                       WAVE=np.linspace(3000.0, 4000.0, 32),
                       SOLSPEC=np.full(32, 1.0e20))
OCC_EVAL_RUNS = 5


def so_deck(deck_file: str = SO_EXPORT):
    """The Mars solar-occultation deck read from its run file (by default
    the ``.npz`` export), table locations against the deck's directory."""
    from archnemesis_tpu_torch.io.hdf5 import load_deck_hdf5

    return load_deck_hdf5(deck_file, base_dir=SO_DECK)


def transit_deck_file(path: str, src: str = SO_EXPORT) -> str:
    """Write to ``path`` the SO export made a transit run as
    tests/test_retrieval_transit.py makes the ``.h5`` one: IFORM =
    TransitDepth and a ``Stellar`` group (``TRANSIT_STELLAR``), edited as
    a dict of the export's datasets."""
    from archnemesis_tpu_torch.enums import SpectraUnit

    with np.load(src, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    flat["Measurement/IFORM"] = np.asarray(int(SpectraUnit.TransitDepth))
    for key, value in TRANSIT_STELLAR.items():
        flat[f"Stellar/{key}"] = np.asarray(value)
    np.savez(path, **flat)
    return path


def golden_tables(kt, wave, pad: float = 0.0):
    """The deck's tables on a golden's wave grid, selected as the JAX
    tests select them (the grids agree within 1e-5 cm-1)."""
    import torch

    kw = kt.wave.detach().cpu().numpy()
    sel = np.where((kw >= wave.min() - pad) & (kw <= wave.max() + pad))[0]
    np.testing.assert_allclose(kw[sel], wave, rtol=0, atol=1e-5)
    idx = torch.as_tensor(sel, device=kt.k.device)
    return kt.replace(wave=kt.wave[idx], k=kt.k[:, idx])


def _so_state(deck, device, ones: bool = False, hydrostat: bool = False):
    """The deck's atmosphere on ``device`` with its .apr a priori applied
    (unit scalings where ``ones``: the AOTF golden's state)."""
    import torch

    from archnemesis_tpu_torch.retrieval.statevector import (
        apply_state,
        read_apr,
    )

    sv = read_apr(f"{SO_DECK}/{SO_RUN}.apr", deck.atmosphere)
    x = np.ones_like(sv.xa) if ones else sv.xa
    return apply_state(deck.atmosphere.to(device),
                       torch.as_tensor(x, device=device), sv,
                       adjust_hydrostat=hydrostat)


def _lbl_ils(deck, wave, vconv, like):
    from archnemesis_tpu_torch.enums import InstrumentLineshape
    from archnemesis_tpu_torch.ops.convolution import ils_weights_lbl

    return like.new_tensor(ils_weights_lbl(
        wave, vconv, deck.geometry.fwhm,
        InstrumentLineshape(deck.settings.ishape)))


def so_golden_spectrum(deck, device, tanhe_shift=None):
    """(convolved (NCONV, NGEOM) spectrum, golden, forward diagnostics) of
    the SO forward as tests/test_forward_so.py computes it."""
    from archnemesis_tpu_torch.forward import (
        forward_so,
        make_forward_config,
        so_geometry,
    )
    from archnemesis_tpu_torch.ops.convolution import apply_ils

    d = np.load(SO_GOLDEN)
    atm = _so_state(deck, device)
    ktw = golden_tables(deck.ktables, d["WAVE"])
    cfg = make_forward_config(atm, ktw, None, iray=deck.settings.iray,
                              ispace=deck.settings.ispace, gasgiant=True)
    geo = so_geometry(atm, deck.layer_config, d["TANHE"])
    spec, diag = forward_so(atm, deck.layer_config, ktw, None, deck.aerosol,
                            cfg, geo, return_diagnostics=True,
                            tanhe_shift=tanhe_shift, device=device)
    nconv = int(d["NCONV"][0])
    conv = apply_ils(_lbl_ils(deck, d["WAVE"], d["VCONV"][:nconv, 0], spec),
                     spec)
    return conv, d["SPECONV"][:nconv, :], diag


def aotf_golden_spectrum(deck, device):
    """(combined (NCONV, NGEOM) spectrum, golden) of the 3-order AOTF
    forward as tests/test_forward_so_aotf.py computes it (unit scalings:
    the reference compounds the orders' scalings, see ``forward_so_aotf``)."""
    import functools

    from archnemesis_tpu_torch.forward import (
        forward_so_aotf,
        make_forward_config,
        so_geometry,
    )
    from archnemesis_tpu_torch.ops.convolution import apply_ils

    d = np.load(AOTF_GOLDEN)
    atm = _so_state(deck, device, ones=True)
    nconv = int(d["NCONV"][0])
    ktabs, cfgs, convs = [], [], []
    for o in range(d["VCONV_AOTF"].shape[2]):
        wave_o = d[f"WAVE_O{o}"]
        ktw = golden_tables(deck.ktables, wave_o, pad=1e-9)
        ktabs.append(ktw)
        cfgs.append(make_forward_config(atm, ktw, None,
                                        iray=deck.settings.iray,
                                        ispace=deck.settings.ispace,
                                        gasgiant=True))
        w = _lbl_ils(deck, wave_o, d["VCONV_AOTF"][:nconv, 0, o],
                     atm.t).to(device)
        convs.append(functools.partial(lambda wv, s, w: apply_ils(w, s),
                                       w=w))
    geo = so_geometry(atm, deck.layer_config, d["TANHE"])
    spec = forward_so_aotf(atm, deck.layer_config, ktabs, None, deck.aerosol,
                           cfgs, geo, convs, d["TRANS_AOTF"], device=device)
    return spec, d["SPECONV"][:nconv, :]


def transit_golden_spectrum(deck, device):
    """(convolved transit depth (NCONV,), golden, transmissions) as
    tests/test_disc_transit.py computes them: the .apr state with the
    hydrostatic rebalance, as nemesisPTfm applies it."""
    from archnemesis_tpu_torch.forward import (
        forward_transit,
        make_forward_config,
    )
    from archnemesis_tpu_torch.ops.convolution import apply_ils

    d = np.load(TRANSIT_GOLDEN)
    atm = _so_state(deck, device, hydrostat=True)
    ktw = golden_tables(deck.ktables, d["WAVE"])
    cfg = make_forward_config(atm, ktw, deck.cia, iray=deck.settings.iray,
                              ispace=deck.settings.ispace, gasgiant=True)
    depth, diag = forward_transit(
        atm, deck.layer_config, ktw, deck.cia, None, cfg,
        stellar_radius_km=float(d["STELLAR_RADIUS_KM"]),
        return_diagnostics=True, device=device)
    conv = apply_ils(_lbl_ils(deck, d["WAVE"], d["VCONV"], depth), depth)
    return conv, d["SPECONV"][:, 0], diag["trans"]


def titan_golden_spectrum(device):
    """(forward_fn(xa), golden, the set-up) of the Titan FOV deck through
    ``make_retrieval_setup``, as tests/test_forward_titan_fov.py runs it."""
    from archnemesis_tpu_torch.retrievals import make_retrieval_setup

    setup = make_retrieval_setup(TITAN_DECK, "ch3cn", device=device)
    d = np.load(TITAN_GOLDEN)
    nconv = int(d["NCONV"][0])
    np.testing.assert_allclose(setup.sv.xa, d["XA"], rtol=1e-10)
    return setup.forward_fn(setup.sv.xa), d["SPECONV"][:nconv, 0], setup


def occultation_golden_cases() -> dict:
    """name -> check(deck, device): the four goldens of the slice at the
    JAX tests' tolerances (rtol, atol); each check raises on a miss and
    returns the largest relative error."""
    def held(got, want, rtol, atol, name):
        got = got.detach().cpu().double().numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=name)
        return float(np.max(np.abs(got - want)
                            / np.maximum(np.abs(want), 1e-300)))

    return {
        "mars_so_fm": lambda deck, device: held(
            *so_golden_spectrum(deck, device)[:2], 1e-6, 1e-10, "mars_so_fm"),
        "mars_so_aotf_fm": lambda deck, device: held(
            *aotf_golden_spectrum(deck, device), 1e-6, 1e-10,
            "mars_so_aotf_fm"),
        "mars_transit_fm": lambda deck, device: held(
            *transit_golden_spectrum(deck, device)[:2], 1e-5, 0.0,
            "mars_transit_fm"),
        "titan_fov_fm": lambda deck, device: held(
            *titan_golden_spectrum(device)[:2], 1e-5, 0.0, "titan_fov_fm"),
    }


def occultation_setups(transit_file: str) -> dict:
    """name -> make(device, dtype): the SO set-up on the export and the
    transit set-up on ``transit_file`` (``transit_deck_file``)."""
    from archnemesis_tpu_torch.retrievals import (
        make_retrieval_setup_so,
        make_retrieval_setup_transit,
    )

    return {
        "SO": lambda device, dtype: make_retrieval_setup_so(
            SO_DECK, SO_RUN, deck_file=SO_EXPORT, device=device,
            dtype=dtype),
        "transit": lambda device, dtype: make_retrieval_setup_transit(
            SO_DECK, SO_RUN, deck_file=transit_file, device=device,
            dtype=dtype),
    }


def _timed(fn, runs: int):
    """(median, min, max host ms ending in a synchronise, peak GiB) of
    ``fn()`` over ``runs`` runs after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return (float(np.median(times)), min(times), max(times),
            torch.cuda.max_memory_allocated() / 2**30)


def _time_jacobians(setup, x, runs: int):
    """``_timed`` of ``forward_and_jacobian`` at ``x``."""
    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian

    return _timed(lambda: forward_and_jacobian(setup.forward_fn, x), runs)


def phase_occultation(card: str):
    """Phase 21: solar occultation, AOTF, transit and the Titan FOV deck
    on the card, the Mars deck read from its ``.npz`` export."""
    import torch

    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
    from archnemesis_tpu_torch.retrievals import retrieval_nemesis

    deck = so_deck()
    for name, check in occultation_golden_cases().items():
        err = check(deck, "cuda")
        _print(f"{name} float64 on the card: golden held (max rel "
               f"{err:.3e})")
    with tempfile.TemporaryDirectory() as tmp:
        transit_file = transit_deck_file(os.path.join(tmp, "transit.npz"))
        for name, make in occultation_setups(transit_file).items():
            s64 = make("cuda", torch.float64)
            s32 = make("cuda", torch.float32)
            cpu = make("cpu", torch.float64)
            x = torch.as_tensor(s64.sv.xa, device="cuda")
            y64, k64 = forward_and_jacobian(s64.forward_fn, x)
            y32, k32 = forward_and_jacobian(s32.forward_fn, x.float())
            y_cpu = cpu.forward_fn(cpu.sv.xa).numpy()
            np.testing.assert_allclose(y64.cpu().numpy(), y_cpu, rtol=1e-10,
                                       atol=0, err_msg=name)
            r = rel_err(y32.double().cpu().numpy(), y64.cpu().numpy())
            col_err, misses = jacobian_column_misses(k32, k64,
                                                     s64.sv.entries)
            _print(f"{name} set-up (NX={s64.sv.nx}, NY={s64.y.shape[0]}) on "
                   f"the card: float64 forward equal to the CPU's within "
                   f"1e-10; float32 vs float64: spectrum max rel "
                   f"{r.max():.3e}, median {np.median(r):.3e} (gate "
                   f"{F32_BOUNDS[0]:.0e}); Jacobian columns' errors over "
                   f"their peaks {np.array2string(col_err, precision=3)} "
                   f"(gate {JAC_F32_BOUND:.0e}); columns whose float64 "
                   f"peak float32 cannot hold: "
                   f"{float32_unheld_columns(k64)}")
            if not r.max() < F32_BOUNDS[0]:
                raise AssertionError(f"{name}: float32 spectrum outside "
                                     f"{F32_BOUNDS[0]:.0e}")
            if misses:
                raise AssertionError(f"{name}: float32 Jacobian columns "
                                     f"outside {JAC_F32_BOUND:.0e}: {misses}")
            for dtype_name, setup, xs in (("float64", s64, x),
                                          ("float32", s32, x.float())):
                med, lo, hi, peak = _time_jacobians(setup, xs,
                                                    OCC_EVAL_RUNS)
                _print(f"forward-plus-Jacobian of the {name} set-up "
                       f"({dtype_name}, {card}): median {med:.3f} ms over "
                       f"{OCC_EVAL_RUNS} runs (min {lo:.3f}, max "
                       f"{hi:.3f}); peak memory {peak:.3f} GiB")
    # write_outputs=False: the run writes nothing into the deck directory
    t0 = time.perf_counter()
    res = retrieval_nemesis(SO_DECK, SO_RUN, nemesis_so=True, niter=3,
                            write_outputs=False, device="cuda",
                            deck_file=SO_EXPORT)
    wall = time.perf_counter() - t0
    if not (np.all(np.isfinite(res.xn))
            and res.phi_history[-1] <= res.phi_history[0]):
        raise AssertionError(f"SO retrieval: phi {res.phi_history}")
    _print(f"retrieval_nemesis(nemesis_so=True, niter=3) on the export "
           f"({card}): {wall:.3f} s, phi {res.phi_history[0]:.6e} -> "
           f"{res.phi_history[-1]:.6e}")
    if "h5py" in sys.modules:
        raise AssertionError("phase 21 imported h5py")


# --- phase 22: table generation on kernel 2

TABLEGEN_FIX = "tests/fixtures/tablegen"
# the production grid: CO's fundamental band at 0.005 cm-1 (50,000 waves),
# 20 pressures from 1e-6 to 10 atm, 10 temperatures from 70 to 400 K;
# the k-table in 1 cm-1 bins (250) with 20 g ordinates
TABLE_WAVE = 2000.0 + 0.005 * np.arange(50_000)
TABLE_PRESS = np.logspace(-6.0, 1.0, 20)
TABLE_TEMP = np.linspace(70.0, 400.0, 10)
TABLE_BINS = 2000.5 + np.arange(250.0)
TABLE_NG = 20
TABLE_CHUNKS = 4
TABLE_KERNEL_RUNS = 3


def tablegen_golden_cases() -> dict:
    """name -> check(ll, device): the table generator against the
    reference's tables ``co_ref.{lta,kta}`` at tests/test_tablegen.py's
    tolerances; each check raises on a miss and returns its largest
    error (relative for the LBL table, in log k for the k-tables)."""
    from archnemesis_tpu_torch.io.ktables import read_kta, read_lta
    from archnemesis_tpu_torch.ops.tablegen import (
        generate_ktable,
        generate_ktable_chunked,
        generate_lbltable,
    )

    def lbl(ll, device):
        ref = read_lta(f"{TABLEGEN_FIX}/co_ref.lta")
        k = generate_lbltable(ll, ref.press, ref.temp, ref.wave,
                              amb_frac=0.9, wn_calc_window=25.0,
                              wn_approx_window=75.0, device=device)
        k = k.cpu().numpy()
        want = ref.k[:, 0, :, :]
        np.testing.assert_allclose(k, want, rtol=3e-7, atol=1e-30)
        return float(np.max(np.abs(k / want - 1.0)))

    def ktable(chunks):
        def check(ll, device):
            ref = read_kta(f"{TABLEGEN_FIX}/co_ref.kta")
            kw = dict(ng=ref.g_ord.size, amb_frac=0.9, wn_calc_window=5.0,
                      wn_approx_window=10.0, device=device)
            if chunks:
                k_g, g_ord, del_g = generate_ktable_chunked(
                    ll, ref.press, ref.temp, ref.wave, n_chunks=chunks, **kw)
            else:
                k_g, g_ord, del_g = generate_ktable(ll, ref.press, ref.temp,
                                                   ref.wave, **kw)
            np.testing.assert_allclose(g_ord, ref.g_ord, rtol=1e-6)
            np.testing.assert_allclose(del_g, ref.del_g, rtol=1e-6)
            err = np.abs(np.log(k_g.cpu().numpy()) - np.log(ref.k))
            # the chunked pipeline's one fine grid (the finest of the
            # (P, T) grid) is resolution-sensitive at the ~1e-2 log level
            # near steep k(g) edges (tests/test_tablegen.py)
            tol = 2e-2 if chunks else 2e-3
            if not err.max() <= tol:
                raise AssertionError(f"k-table (chunks {chunks}): log k off "
                                     f"by {err.max():.3e} > {tol}")
            return float(err.max())
        return check

    return {"co_ref.lta": lbl, "co_ref.kta": ktable(0),
            "co_ref.kta, 1 chunk": ktable(1),
            "co_ref.kta, 3 chunks": ktable(3)}


# float64 kernel against its plain version at the table shape: phase 7's
# rtol 1e-10 down to TABLE_F64_DEPTH of each column's peak, and
# TABLE_F64_RTOL below it. In the Doppler far wings of the 1e-6 and
# 2.3e-6 atm columns (Voigt y ~ 1e-5 at |x| up to ~1e4) the real part of
# the Faddeeva function cancels by ~x / y, and the two versions' rounding
# differs there by up to 3.0e-10 (measured on an H100), at 1.6e-11 of
# the column's peak; above 1e-6 of the peak they agree within 4.3e-11.
TABLE_F64_DEPTH = 1.0e-6
TABLE_F64_RTOL = 1.0e-9


def table_f64_check(k, ref, what: str):
    """float64 ``k`` against ``ref`` (NWAVE, NCOL): within
    ``LBL_F64_RTOL`` at or above ``TABLE_F64_DEPTH`` of each column's
    peak, within ``TABLE_F64_RTOL`` everywhere."""
    err = (k - ref).abs() / ref.abs().clamp_min(1e-300)
    deep = ref.abs() < TABLE_F64_DEPTH * ref.abs().max(dim=0).values
    upper = err.masked_fill(deep, 0.0).max().item()
    worst = err.max().item()
    ok = upper <= LBL_F64_RTOL and worst <= TABLE_F64_RTOL
    _print(f"{what}: float64 max rel {upper:.3e} at or above "
           f"{TABLE_F64_DEPTH:.0e} of each column's peak (gate "
           f"{LBL_F64_RTOL:.0e}), {worst:.3e} everywhere (gate "
           f"{TABLE_F64_RTOL:.0e}; {int(deep.sum())} deeper elements) "
           f"({'ok' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"{what}: float64 outside its gates")


def table_kernel_case(ll, device, dtype):
    """(lines, blocks, (t, p, amb) columns) of the production LBL table's
    synthesis: kernel 2's shape in table generation, the 200 (P, T) pairs
    as its layers."""
    import torch

    from archnemesis_tpu_torch.io.linedata import _slice_lines
    from archnemesis_tpu_torch.ops.lbl import build_blocks
    from archnemesis_tpu_torch.ops.tablegen import _pt_columns

    lines = _slice_lines(ll, TABLE_WAVE.min(), TABLE_WAVE.max())
    blocks = build_blocks(TABLE_WAVE, lines.nu)
    pcol, tcol = _pt_columns(TABLE_PRESS, TABLE_TEMP)
    cols = tuple(torch.as_tensor(c, dtype=dtype, device=device)
                 for c in (tcol, pcol, np.ones_like(pcol)))
    return lines, blocks, cols


def _table_kernel_vs_plain(ll, card: str) -> dict:
    """Kernel 2 against its plain version at the table-generation shape
    (50,000 waves x 200 columns), in float64 and float32, and its time
    beside its bound; returns the numbers."""
    import torch

    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.ops.lbl import lbl_cross_section_plain

    lines, blocks, cols = table_kernel_case(ll, "cuda", torch.float64)
    k64, plain64 = lbl_kernel_and_plain(lines, blocks, *cols)
    table_f64_check(k64, plain64, "table shape kernel vs plain")
    cols32 = tuple(c.float() for c in cols)
    k32, plain32 = lbl_kernel_and_plain(lines, blocks, *cols32)
    _lbl_f32_check(k32, plain32, "table shape kernel vs plain (float32)")
    # the float32 synthesis against float64 at 1e-6 atm and 70 K: held no
    # further off than the plain float32 version plus phase 7's bound
    r_kernel = rel_err(k32.double().cpu().numpy(), k64.cpu().numpy())
    r_plain = rel_err(plain32.double().cpu().numpy(), k64.cpu().numpy())
    _print(f"table shape float32 vs float64: kernel max rel "
           f"{r_kernel.max():.3e} (median {np.median(r_kernel):.3e}), plain "
           f"float32 version {r_plain.max():.3e} (median "
           f"{np.median(r_plain):.3e})")
    if not r_kernel.max() <= r_plain.max() + LBL_F32_BOUNDS[0]:
        raise AssertionError("table shape: float32 kernel further off "
                             "float64 than the plain float32 version plus "
                             f"{LBL_F32_BOUNDS[0]:.0e}")
    del plain32, k32
    spec = lbl_cuda.make_spec(lines, blocks)
    static = lbl_cuda.static_inputs(spec, torch.float64,
                                    torch.device("cuda"))
    ms = _cuda_ms(lambda: lbl_cuda._launch(spec, static, *cols),
                  reps=TABLE_KERNEL_RUNS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lbl_cross_section_plain(lines, blocks, *cols)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    host = [c.cpu().numpy() for c in cols]
    bound_ms, bound_by, ops = lbl_bound_ms(lines, blocks, *host, itemsize=8)
    _print(f"kernel 2 at the table shape ({TABLE_WAVE.size} waves x "
           f"{lines.n_lines} lines x {len(host[0])} (P, T) columns, float64, "
           f"{card}): {ms:.4f} ms against its bound {bound_ms:.4f} ms "
           f"({bound_by}, {ops:.4g} operations; {ms / bound_ms:.2f}x); the "
           f"plain version {plain_ms:.3f} ms")
    return dict(ms=ms, bound_ms=bound_ms, plain_ms=plain_ms)


def _ktable_chunk_bounds(ll) -> float:
    """Kernel 2's bound (ms) summed over the production k-table's chunk
    syntheses, from their inputs."""
    from archnemesis_tpu_torch.ops.lbl import build_blocks
    from archnemesis_tpu_torch.ops.tablegen import chunk_grid

    total = 0.0
    for idx in np.array_split(np.arange(TABLE_BINS.size), TABLE_CHUNKS):
        ll_c, wavecalc, pcol, tcol, *_ = chunk_grid(
            ll, TABLE_PRESS, TABLE_TEMP, TABLE_BINS[idx], 1.0, 75.0,
            2_000_000)
        blocks = build_blocks(wavecalc, ll_c.nu)
        total += lbl_bound_ms(ll_c, blocks, tcol, pcol, np.ones_like(pcol),
                              itemsize=8)[0]
    return total


def _launched(fn):
    """(fn(), kernel-2 launches it made, host ms to its end on the card)."""
    import torch

    from archnemesis_tpu_torch.ops import lbl_cuda

    torch.cuda.synchronize()
    lbl_cuda.lbl_cross_section.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, lbl_cuda.lbl_cross_section.launches,
            (time.perf_counter() - t0) * 1e3)


def phase_tablegen(card: str):
    """Phase 22: table generation on kernel 2. The reference's tables, the
    kernel against its plain version at the table shape, then one
    production grid (an LBL table and a k-table). Returns (kernel-2
    launches of the production grid, the table-shape numbers)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from archnemesis_tpu_torch.io.ktables import (
        read_kta,
        read_lta,
        write_kta,
        write_lta,
    )
    from archnemesis_tpu_torch.io.linedata import read_ans_linedata
    from archnemesis_tpu_torch.ops.tablegen import (
        generate_ktable_chunked,
        generate_lbltable,
    )

    ll = read_ans_linedata(LINEDATA_NPZ, gas_id=5, iso_id=1)
    for name, check in tablegen_golden_cases().items():
        _print(f"{name} float64 on the card: reference table held (max "
               f"error {check(ll, 'cuda'):.3e})")
    shape = _table_kernel_vs_plain(ll, card)

    def lbl_table():
        return generate_lbltable(ll, TABLE_PRESS, TABLE_TEMP, TABLE_WAVE,
                                 device="cuda")

    def k_table():
        return generate_ktable_chunked(ll, TABLE_PRESS, TABLE_TEMP,
                                       TABLE_BINS, ng=TABLE_NG,
                                       n_chunks=TABLE_CHUNKS, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    k_lbl, lbl_launches, lbl_ms = _launched(lbl_table)
    lbl_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    (k_g, g_ord, del_g), kta_launches, kta_ms = _launched(k_table)
    kta_peak = torch.cuda.max_memory_allocated() / 2**30
    if lbl_launches != 1 or kta_launches != TABLE_CHUNKS:
        raise AssertionError(f"table generation: {lbl_launches} / "
                             f"{kta_launches} launches, expected 1 / "
                             f"{TABLE_CHUNKS}")
    if not (torch.isfinite(k_lbl).all() and (k_lbl >= 0).all()
            and torch.isfinite(k_g).all() and (k_g > 0).all()
            and (k_g.diff(dim=1) >= 0).all()):
        raise AssertionError("table generation: tables not finite, "
                             "negative or unsorted along g")
    with tempfile.TemporaryDirectory() as tmp:
        write_lta(os.path.join(tmp, "co"), 5, 1, TABLE_PRESS, TABLE_TEMP,
                  float(TABLE_WAVE[0]), 0.005, k_lbl)
        write_kta(os.path.join(tmp, "co"), 5, 1, g_ord, del_g, TABLE_PRESS,
                  TABLE_TEMP, TABLE_BINS, k_g)
        back_lbl = read_lta(os.path.join(tmp, "co.lta"))
        back_kta = read_kta(os.path.join(tmp, "co.kta"))
    np.testing.assert_allclose(back_lbl.k[:, 0], k_lbl.cpu().numpy(),
                               rtol=3e-7, atol=1e-37)
    np.testing.assert_allclose(back_kta.k, k_g.cpu().numpy(), rtol=3e-7,
                               atol=1e-37)
    np.testing.assert_allclose(back_lbl.wave, TABLE_WAVE, rtol=0, atol=1e-3)

    # the kernel's share of the k-table's device time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        k_table()
        torch.cuda.synchronize()
    by_kernel = {e.key: e.self_device_time_total / 1e3
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
    device_ms = sum(by_kernel.values())
    kernel_ms = sum(v for k, v in by_kernel.items()
                    if "line_kernel" in k or "pair_kernel" in k)
    bound = _ktable_chunk_bounds(ll)
    _print(f"production LBL table ({TABLE_WAVE.size} waves x "
           f"{TABLE_PRESS.size} pressures x {TABLE_TEMP.size} temperatures, "
           f"float64, {card}): {lbl_ms:.3f} ms, {lbl_launches} launch, peak "
           f"memory {lbl_peak:.3f} GiB")
    _print(f"production k-table ({TABLE_BINS.size} bins x {TABLE_NG} g x "
           f"{TABLE_PRESS.size * TABLE_TEMP.size} (P, T), {TABLE_CHUNKS} "
           f"chunks, float64, {card}): {kta_ms:.3f} ms, {kta_launches} "
           f"launches, peak memory {kta_peak:.3f} GiB; device time "
           f"{device_ms:.3f} ms of which kernel 2 {kernel_ms:.3f} ms (share "
           f"{kernel_ms / device_ms:.4f}) against its bound {bound:.4f} ms "
           f"summed over the chunks ({kernel_ms / bound:.2f}x); "
           f"{sum(1 for _ in by_kernel)} kernel names")
    _print(f"table generation: kernel 2 at the table shape {shape['ms']:.4f}"
           f" ms (bound {shape['bound_ms']:.4f} ms)")
    return lbl_launches + kta_launches, shape


# --- phases 23-24: non-LTE emissions, telluric transmission, multi-location

PORT_DATA = "archnemesis_tpu_torch/data"
EM_GOLDEN = "tests/goldens/jupiter_emissions_fm.npz"
# the two emission tables of tests/fixtures/jupiter_emiss (C2H2 chemical,
# NH3 fluorescence), in the JAX test's sorted order, as .npz exports
EMISS_NAMES = ("emiss_c2h2_chem", "emiss_nh3_fluor")
EMISS_EXPORTS = tuple(f"{PORT_DATA}/{n}.npz" for n in EMISS_NAMES)
# the telluric run: jupiter_nadir as an HDF5 run file with a Telluric group
# (tests/port_cases.write_telluric_run), its .npz export and two .kta
# tables on a coarse grid over the deck's 5-1399 cm-1 window
TELLURIC_EXPORT = f"{PORT_DATA}/jupiter_telluric.npz"
TELLURIC_TABLES = (("telluric_h2o.kta", 1), ("telluric_co2.kta", 2))
TELLURIC_WAVE = np.linspace(0.0, 1428.0, 120)
TELLURIC_ALTITUDE = 4207.3
TELLURIC_EMISS_ANG = 160.0
# model 202: the telluric H2O VMR scale
TELLURIC_APR_BLOCK = "1 0 202\n1.0 0.1\n"


def telluric_deck(base: str, tables_dir: str = PORT_DATA) -> str:
    """A copy of jupiter_nadir under ``base`` for the telluric run: the two
    telluric tables beside its files (the run's relative LOCATIONs) and
    an .apr of model 0 and model 202. The run itself is
    ``TELLURIC_EXPORT``, read through ``deck_file=``."""
    deck = copy_deck(DECK, base)
    for name, _ in TELLURIC_TABLES:
        shutil.copy(os.path.join(tables_dir, name), deck)
    _write_apr(deck, [TELLURIC_APR_BLOCK])
    return deck


EMISS_RUNS = 5
TELLURIC_EVAL_RUNS = 3
MULTILOC_RUNS = 5
# the window of the emission Jacobian held to the CPU: the C2H2 band
EMISS_JAC_WINDOW = (700.0, 800.0)
# float32 against float64 of the multi-location forward's single-location
# counterpart: one float32 forward against another, batched or not
MULTILOC_F32_SELF = 1.0e-6
MULTILOC_EMISS = (0.0, 30.0, 55.0)
MULTILOC_LOCS = ("3 40.0\n10.0 20.0 1.0 0.1\n-20.0 35.0 1.05 0.2\n"
                 "15.0 80.0 0.95 0.15\n")
# the CPU's width for model 1002's Jacobian (the card's runs at 8192): the
# plain combine under jacfwd costs ~0.7 s a pair at 64 waves on 3 locations
MULTILOC_CPU_NWAVE = 32


def emission_case(device, dtype=None, window=None):
    """(deck tuple, emission tables, their atmosphere columns, stellar
    distance) of the ``jupiter_emissions_fm`` golden on ``device``: the
    golden deck (``golden_deck``) with both tables read from their
    ``.npz`` exports (no h5py), in ``dtype`` (None = float64), its
    k-tables cut to ``window`` (cm-1) where one is given."""
    from archnemesis_tpu_torch.core.spectra import cast_deck
    from archnemesis_tpu_torch.io.emissions import read_emission_tables
    from archnemesis_tpu_torch.ops.emissions import locate_emission_gases

    deck = golden_deck(device)
    em = read_emission_tables(list(EMISS_EXPORTS)).to(device)
    if window is not None:
        atm, laycfg, ktab, cia, aero, surf, cfg = deck
        sel = ((ktab.wave >= window[0]) & (ktab.wave <= window[1]))
        ktab = ktab.replace(wave=ktab.wave[sel], k=ktab.k[:, sel])
        deck = (atm, laycfg, ktab, cia, aero, surf, cfg)
    if dtype is not None:
        deck, em = cast(deck, dtype), cast_deck(em, dtype)
    cols = locate_emission_gases(em, deck[0].gas_id, deck[0].iso_id)
    d = np.load(EM_GOLDEN)
    dist = float(d["DIST"]) if bool(d["SOLEXIST"]) else None
    return deck, em, cols, dist


def emission_state_forward(case, device, with_emission: bool = True):
    """f(x) -> (NWAVE,): the emission case's forward with the temperature
    profile scaled by x[0] and the two emitting gases' VMRs (C2H2, NH3)
    by x[1] and x[2]."""
    from archnemesis_tpu_torch.forward import forward_nadir
    from archnemesis_tpu_torch.rt.atmosphere import set_column

    (atm, laycfg, ktab, cia, aero, surf, cfg), em, cols, dist = case
    kw = (dict(emis=em, emis_gas_cols=cols, emis_dist=dist)
          if with_emission else {})

    def f(x):
        vmr = atm.vmr
        for i, c in enumerate(cols):
            vmr = set_column(vmr, c, vmr[:, c] * x[1 + i])
        a = atm.replace(t=atm.t * x[0], vmr=vmr)
        return forward_nadir(a, laycfg, ktab, cia, aero, surf, cfg,
                             emiss_ang=0.0, sol_ang=180.0, device=device,
                             **kw)[:, 0]

    return f


def phase_emissions(card: str):
    """Phase 23: non-LTE emissions on the card. Returns (kernel-1 launches
    of one emission forward, kernel-1t launches of one forward-plus-
    Jacobian evaluation)."""
    import torch

    from archnemesis_tpu_torch.ops.convolution import conv_channel_interp

    t0 = time.perf_counter()
    case = emission_case("cuda")
    f64 = emission_state_forward(case, "cuda")
    one = torch.ones(3, dtype=torch.float64, device="cuda")
    spec, primal = _primal_launches(lambda: f64(one))
    if primal != 6:
        raise AssertionError(f"emissions: {primal} primal launches, "
                             "expected 6")
    d = np.load(EM_GOLDEN)
    nconv = int(d["NCONV"][0])

    def speconv(y):
        return conv_channel_interp(
            case[0][2].wave.to(y.dtype), y,
            y.new_tensor(d["VCONV"][:nconv, 0])).double().cpu().numpy()

    got, want = speconv(spec), d["SPECONV"][:nconv, 0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    bare = emission_state_forward(case, "cuda", with_emission=False)(one)
    share = float((1.0 - speconv(bare) / got).max())
    _print(f"emissions (jupiter_emissions_fm: 559 waves, 698 channels, C2H2 "
           f"chemical + NH3 fluorescence from the .npz exports) float64 on "
           f"the card: golden within rtol 1e-5 (max rel "
           f"{np.abs(got / want - 1).max():.3e}); the emission's largest "
           f"share of a channel {share:.4f}; {primal} primal launches")

    case32 = emission_case("cuda", torch.float32)
    f32 = emission_state_forward(case32, "cuda")
    r = rel_err(speconv(f32(one.float())), got)
    _print(f"emissions float32 vs float64: max rel {r.max():.3e}, median "
           f"{np.median(r):.3e} (gates {F32_BOUNDS[0]:.0e} / "
           f"{F32_BOUNDS[1]:.0e}, phase 3's)")
    if not (r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1]):
        raise AssertionError("emissions: float32 outside 1e-4 / 1e-5")

    # forward-plus-Jacobian (3 state elements) on the card against the CPU,
    # on the C2H2 band
    win_card = emission_state_forward(
        emission_case("cuda", window=EMISS_JAC_WINDOW), "cuda")
    win_cpu = emission_state_forward(
        emission_case("cpu", window=EMISS_JAC_WINDOW), "cpu")
    (k_card, y_card), fused = _fused_launches(
        lambda: torch.func.jacfwd(lambda x: (win_card(x),) * 2,
                                  has_aux=True)(one))
    k_cpu, y_cpu = torch.func.jacfwd(lambda x: (win_cpu(x),) * 2,
                                     has_aux=True)(one.cpu())
    np.testing.assert_allclose(y_card.cpu().numpy(), y_cpu.numpy(),
                               rtol=1e-10, atol=0)
    col_err = ((k_card.cpu() - k_cpu).abs().max(dim=0).values
               / k_cpu.abs().max(dim=0).values).numpy()
    if fused != 6 or not col_err.max() < 1e-10:
        raise AssertionError(f"emissions Jacobian: {fused} fused launches, "
                             f"column errors {col_err}")
    _print(f"emission forward-plus-Jacobian (T, C2H2 and NH3 scales, "
           f"{k_card.shape[0]} waves of 700-800 cm-1) on the card: the CPU's "
           f"spectrum within 1e-10, columns within {col_err.max():.3e} of "
           f"their peaks; {fused} fused launches")

    evaluations = {}
    for label, with_emission in (("with the tables", True),
                                 ("without", False)):
        f = emission_state_forward(case, "cuda", with_emission)
        fwd = _timed(lambda: f(one), EMISS_RUNS)
        ev = _timed(lambda: torch.func.jacfwd(f)(one), EMISS_RUNS)
        evaluations[label] = ev
        _print(f"emission deck {label} (float64, {card}): forward median "
               f"{fwd[0]:.3f} ms (min {fwd[1]:.3f}, max {fwd[2]:.3f}), peak "
               f"{fwd[3]:.3f} GiB; forward-plus-Jacobian (3 columns) median "
               f"{ev[0]:.3f} ms (min {ev[1]:.3f}, max {ev[2]:.3f}), peak "
               f"{ev[3]:.3f} GiB over {EMISS_RUNS} runs")
    _, fused_full = _fused_launches(lambda: torch.func.jacfwd(f64)(one))
    if "h5py" in sys.modules:
        raise AssertionError("phase 23 imported h5py")
    _print(f"phase 23: {time.perf_counter() - t0:.1f} s")
    return primal, fused_full


def thin_export(src: str, dst: str, vmin: float, vmax: float) -> str:
    """A copy of a run file's ``.npz`` export keeping the channels in
    [vmin, vmax] (the set-up's calc window shrinks with them); written
    without h5py."""
    with np.load(src) as z:
        flat = {k: z[k] for k in z.files}
    nconv = int(flat["Measurement/NCONV"][0])
    v = flat["Measurement/VCONV"][:nconv, 0]
    keep = np.where((v >= vmin) & (v <= vmax))[0]
    for key in ("VCONV", "MEAS", "ERRMEAS"):
        flat[f"Measurement/{key}"] = flat[f"Measurement/{key}"][keep]
    flat["Measurement/NCONV"] = np.asarray([keep.size], dtype=np.int32)
    np.savez_compressed(dst, **flat)
    return dst


def _telluric_case(card: str, base: str):
    """The telluric run on the card. Returns (kernel-1 launches of one
    forward, kernel-1t launches of one evaluation)."""
    import torch

    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
    from archnemesis_tpu_torch.retrievals import make_retrieval_setup

    deck = telluric_deck(base)
    s64 = make_retrieval_setup(deck, "cirstest", device="cuda",
                               deck_file=TELLURIC_EXPORT)
    s32 = make_retrieval_setup(deck, "cirstest", device="cuda",
                               deck_file=TELLURIC_EXPORT,
                               dtype=torch.float32)
    nx, ny = s64.sv.nx, s64.y.shape[0]
    xa = torch.as_tensor(s64.sv.xa, device="cuda")
    y64, primal = _primal_launches(lambda: s64.forward_fn(xa))
    (yk, k64), fused = _fused_launches(
        lambda: forward_and_jacobian(s64.forward_fn, xa))
    if primal != 7 or fused != 7:
        raise AssertionError(f"telluric: {primal} primal, {fused} fused "
                             "launches, expected 7 (6 + the telluric pair)")
    torch.testing.assert_close(yk, y64, rtol=1e-12, atol=0)
    if not (torch.isfinite(k64).all() and k64[:, nx - 1].abs().max() > 0):
        raise AssertionError("telluric: Jacobian not finite or model 202's "
                             "column zero")
    y32, k32 = forward_and_jacobian(s32.forward_fn, xa.float())
    r = rel_err(y32.double().cpu().numpy(), y64.cpu().numpy())
    col_err, misses = jacobian_column_misses(k32, k64, s64.sv.entries)
    _print(f"telluric run (jupiter_nadir + Telluric group, NX={nx}: model 0 "
           f"and 202, NY={ny}) on the card: {primal} primal launches per "
           f"forward, {fused} fused per evaluation; float32 vs float64: "
           f"spectrum max rel {r.max():.3e}, median {np.median(r):.3e} "
           f"(gates {F32_BOUNDS[0]:.0e} / {F32_BOUNDS[1]:.0e}); Jacobian max "
           f"error over column peak {col_err.max():.3e} (model 202's "
           f"{col_err[nx - 1]:.3e}; gate {JAC_F32_BOUND:.0e}); columns "
           f"outside: {misses if misses else 'none'}")
    if not (r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1]):
        raise AssertionError("telluric: float32 spectrum outside 1e-4 / 1e-5")
    if misses:
        raise AssertionError(f"telluric: float32 Jacobian columns outside "
                             f"{JAC_F32_BOUND:.0e}: {misses}")
    del k64, k32
    for dtype_name, setup, x in (("float64", s64, xa),
                                 ("float32", s32, xa.float())):
        med, lo, hi, peak = _time_jacobians(setup, x, TELLURIC_EVAL_RUNS)
        _print(f"forward-plus-Jacobian of the telluric run ({dtype_name}, "
               f"{card}): median {med:.3f} ms over {TELLURIC_EVAL_RUNS} runs "
               f"(min "
               f"{lo:.3f}, max {hi:.3f}); peak memory {peak:.3f} GiB")
    del s32

    # the card against the CPU, on the run's 600-700 cm-1 channels: the
    # spectrum and the whole Jacobian against the CPU's forward and three
    # columns (model 202's and two of model 0's)
    thin = thin_export(TELLURIC_EXPORT, os.path.join(base, "thin.npz"),
                       600.0, 700.0)
    card_thin = make_retrieval_setup(deck, "cirstest", device="cuda",
                                     deck_file=thin)
    cpu_thin = make_retrieval_setup(deck, "cirstest", device="cpu",
                                    deck_file=thin)
    y, kk = forward_and_jacobian(card_thin.forward_fn, xa)
    np.testing.assert_allclose(y.cpu().numpy(),
                               cpu_thin.forward_fn(cpu_thin.sv.xa).numpy(),
                               rtol=1e-10, atol=0)
    cols = [nx - 1, 20, 60]
    k_cpu = _cpu_jacobian_columns(cpu_thin, cols).numpy()
    col_err = (np.abs(kk.cpu().numpy()[:, cols] - k_cpu).max(axis=0)
               / np.abs(k_cpu).max(axis=0))
    if not col_err.max() < 1e-10:
        raise AssertionError(f"telluric: Jacobian columns {cols} off the CPU "
                             f"by {col_err}")
    _print(f"telluric run thinned to its {y.shape[0]} channels of 600-700 "
           f"cm-1 (from the export, without h5py) float64 on the card: the "
           f"CPU's spectrum within 1e-10, columns {cols} within "
           f"{col_err.max():.3e} of their peaks")
    return primal, fused


def multiloc_case(nwave: int, dtype, device):
    """(stacked atmosphere, laycfg, ktab, surf, cfg) of the headline deck
    at three locations: tests/test_multiloc.py's perturbations (T x 1.05
    at 10 degrees; T x 0.95 and VMR x 1.1 at -20)."""
    from archnemesis_tpu_torch.core.types import stack_atmospheres
    from archnemesis_tpu_torch.synthetic import headline_deck

    atm, laycfg, ktab, surf, cfg = headline_deck(nwave, dtype=dtype,
                                                 device=device)
    lat = atm.latitude
    multi = stack_atmospheres([
        atm,
        atm.replace(t=atm.t * 1.05, latitude=lat.new_tensor(10.0)),
        atm.replace(t=atm.t * 0.95, vmr=atm.vmr * 1.1,
                    latitude=lat.new_tensor(-20.0)),
    ])
    return multi, laycfg, ktab, surf, cfg


def model_1002_entry(base: str, atm):
    """Model 1002 on the temperature at ``MULTILOC_LOCS``' three
    locations, parsed from an .apr block as ``read_apr`` parses it."""
    import io

    from archnemesis_tpu_torch.models import MODEL_REGISTRY

    locs = os.path.join(base, "locs.dat")
    with open(locs, "w") as f:
        f.write(MULTILOC_LOCS)
    ctx = dict(npro=atm.h.shape[-1], gas_id=atm.gas_id, iso_id=atm.iso_id,
               ndust=atm.dust.shape[-1])
    return MODEL_REGISTRY[1002].from_apr(io.StringIO(locs + "\n"),
                                         [0, 0, 1002], 0, ctx)


def _multiloc_case(card: str, base: str):
    """The multi-location headline and model 1002 on the card. Returns
    (kernel-1 launches of one multi-location forward, kernel-1t launches
    of one Jacobian)."""
    import torch

    from archnemesis_tpu_torch.forward import forward_nadir
    from archnemesis_tpu_torch.models import MODEL_REGISTRY
    from archnemesis_tpu_torch.multiloc import (
        forward_nadir_multiloc,
        select_location,
    )

    specs = {}
    for dtype in (torch.float64, torch.float32):
        multi, laycfg, ktab, surf, cfg = multiloc_case(8192, dtype, "cuda")
        args = (laycfg, ktab, None, None, surf, cfg)
        torch.cuda.reset_peak_memory_stats()
        spec, primal = _primal_launches(lambda: forward_nadir_multiloc(
            multi, *args, emiss_ang=MULTILOC_EMISS, device="cuda"))
        peak = torch.cuda.max_memory_allocated() / 2**30
        if primal != 6:
            raise AssertionError(f"multi-location forward: {primal} primal "
                                 "launches, expected 6 for 3 locations")
        singles = torch.stack([forward_nadir(
            select_location(multi, i), *args, emiss_ang=MULTILOC_EMISS[i],
            device="cuda")[:, 0] for i in range(3)], dim=1)
        r = rel_err(spec.double().cpu().numpy(),
                    singles.double().cpu().numpy())
        bound = 2e-12 if dtype == torch.float64 else MULTILOC_F32_SELF
        if not r.max() < bound:
            raise AssertionError(f"multi-location {dtype}: {r.max():.3e} "
                                 f"off the single forwards (bound {bound})")
        ms = _timed(lambda: forward_nadir_multiloc(
            multi, *args, emiss_ang=MULTILOC_EMISS, device="cuda"),
            MULTILOC_RUNS)
        ms1 = _timed(lambda: [forward_nadir(
            select_location(multi, i), *args, emiss_ang=MULTILOC_EMISS[i],
            device="cuda") for i in range(3)], MULTILOC_RUNS)
        specs[dtype] = spec
        _print(f"multi-location headline (3 locations x 8192 waves x 20 g x "
               f"71 layers x 7 gases, {dtype}, {card}): {primal} primal "
               f"launches per forward; equal to three single forwards within "
               f"{r.max():.3e} (bound {bound:.0e}); median {ms[0]:.3f} ms "
               f"over {MULTILOC_RUNS} runs (min {ms[1]:.3f}, max "
               f"{ms[2]:.3f}) against {ms1[0]:.3f} ms for the three single "
               f"forwards; peak memory {peak:.3f} GiB")
    r = rel_err(specs[torch.float32].double().cpu().numpy(),
                specs[torch.float64].cpu().numpy())
    _print(f"multi-location float32 vs float64: max rel {r.max():.3e}, "
           f"median {np.median(r):.3e}")
    if not (r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1]):
        raise AssertionError("multi-location float32 outside 1e-4 / 1e-5")

    # model 1002: a jacfwd of the three per-location temperature scales
    def jac_of(nwave, device):
        multi, laycfg, ktab, surf, cfg = multiloc_case(nwave, torch.float64,
                                                       device)
        parsed = model_1002_entry(base, multi)

        def f(x):
            m = MODEL_REGISTRY[1002].apply(parsed.entry, multi, x)
            return forward_nadir_multiloc(m, laycfg, ktab, None, None, surf,
                                          cfg, emiss_ang=MULTILOC_EMISS,
                                          device=device)

        x0 = torch.as_tensor(parsed.x0, device=device)
        return lambda: torch.func.jacfwd(f)(x0)

    full = jac_of(8192, "cuda")
    jac, fused, emission = _jacobian_launches(full)
    if (fused, emission) != (6, 1) or not torch.isfinite(jac).all():
        raise AssertionError(f"model 1002 Jacobian: {fused} fused and "
                             f"{emission} emission tangent launches")
    ms = _timed(full, TELLURIC_EVAL_RUNS)
    del jac
    small = jac_of(MULTILOC_CPU_NWAVE, "cuda")()
    want = jac_of(MULTILOC_CPU_NWAVE, "cpu")()
    col_err = [float((small[:, :, j].cpu() - want[:, :, j]).abs().max()
                     / want[:, :, j].abs().max()) for j in range(3)]
    if not max(col_err) < 1e-10:
        raise AssertionError(f"model 1002 Jacobian off the CPU: {col_err}")
    _print(f"model 1002 jacfwd (3 per-location temperature scales, headline "
           f"at 3 locations, float64, {card}): {fused} fused and {emission} "
           f"emission tangent launches; median "
           f"{ms[0]:.3f} ms over {TELLURIC_EVAL_RUNS} runs (min {ms[1]:.3f}, "
           f"max {ms[2]:.3f}), peak memory {ms[3]:.3f} GiB; at "
           f"{MULTILOC_CPU_NWAVE} waves the CPU's columns within "
           f"{max(col_err):.3e} of their peaks")
    return primal, fused


def phase_telluric_multiloc(card: str):
    """Phase 24: the telluric run and the multi-location forward on the
    card. Returns (kernel-1 launches, kernel-1t launches) of their main
    paths."""
    with tempfile.TemporaryDirectory() as base:
        t0 = time.perf_counter()
        tel = _telluric_case(card, base)
        t1 = time.perf_counter()
        loc = _multiloc_case(card, base)
        _print(f"phase 24: telluric {t1 - t0:.1f} s, multi-location "
               f"{time.perf_counter() - t1:.1f} s")
    if "h5py" in sys.modules:
        raise AssertionError("phase 24 imported h5py")
    return tel[0] + loc[0], tel[1] + loc[1]


# --- phase 25: database ingestion into kernel 2

# the HITRAN catalogue: 500,000 160-byte records (80 MB), of which the CO
# records (HITRAN molecule 5) lie at 1,900-2,300 cm-1 by local isotope and
# the rest are other molecules at 500-12,000 cm-1; about 7,500 CO iso-1
# lines fall inside the grid's reach (INGEST_WINDOW)
INGEST_RECORDS = 500_000
INGEST_CO = {"1": 8_000, "2": 11_000, "3": 11_000}
INGEST_SEED = 25
# the grid of phase 22's production table: 2000-2250 cm-1 at 0.005 cm-1
INGEST_WAVE = TABLE_WAVE
# lines farther than wn_approx_window (75 cm-1) from the grid add nothing
INGEST_WINDOW = (float(TABLE_WAVE[0]) - 75.0, float(TABLE_WAVE[-1]) + 75.0)
GEISA_RECORDS = 20_000
EXOMOL_STATES, EXOMOL_TRANS = 5_000, 200_000
INGEST_KERNEL_RUNS = 10
# (field, first byte, width, decimals) of the fixed-point fields of a
# HITRAN 160-byte record
_PAR_FIXED = (("nu", 3, 12, 6), ("gamma_amb", 35, 5, 4),
              ("gamma_self", 40, 5, 4), ("elower", 45, 10, 4),
              ("n_amb", 55, 4, 2), ("delta_amb", 59, 8, 6))


def _fortran_fixed(values, width: int, decimals: int) -> list:
    """Each value as a fixed-point field of ``width`` characters; a field
    one too wide loses its leading zero, as Fortran writes it (0.0676 ->
    .0676, -0.005 -> -.005)."""
    out = []
    for x in values:
        s = f"{x:{width}.{decimals}f}"
        if len(s) > width:
            s = s.replace("0.", ".", 1)
        out.append(s)
    return out


def _put_column(mat, start: int, strings: list, width: int):
    """Write equal-width strings into bytes ``start:start + width`` of
    every row of a (N, stride) uint8 record matrix."""
    raw = "".join(strings).encode()
    if len(raw) != mat.shape[0] * width:
        raise ValueError(f"a field of width {width} overflowed")
    mat[:, start:start + width] = np.frombuffer(raw, np.uint8).reshape(-1,
                                                                       width)


def ingest_par(n: int = INGEST_RECORDS, seed: int = INGEST_SEED,
               co: dict = None, width: int = 160) -> bytes:
    """A HITRAN ``.par`` catalogue of ``n`` records from ``seed``: the CO
    records of ``co`` (local iso char -> count) at 1,900-2,300 cm-1, the
    rest of molecules 1-55 but CO at 500-12,000 cm-1 with iso chars 1-9,
    0 (10), A and B (11, 12), in a shuffled order. Strengths 1e-28-1e-19
    (log-uniform), every fifth self width 0 (the air fallback), Fortran
    fields without a leading zero."""
    rng = np.random.default_rng(seed)
    co = INGEST_CO if co is None else co
    n_co = sum(co.values())
    mol = np.concatenate([np.full(n_co, 5), rng.choice(
        np.setdiff1d(np.arange(1, 56), [5]), n - n_co)])
    iso = np.concatenate([np.repeat(list(co), list(co.values())), rng.choice(
        list("1234567890AB"), n - n_co)])
    cols = dict(
        nu=np.concatenate([rng.uniform(1900.0, 2300.0, n_co),
                           rng.uniform(500.0, 12000.0, n - n_co)]),
        gamma_amb=rng.uniform(0.03, 0.09, n),
        gamma_self=np.where(np.arange(n) % 5 == 0, 0.0,
                            rng.uniform(0.04, 0.1, n)),
        elower=rng.uniform(0.0, 3000.0, n),
        n_amb=rng.uniform(0.5, 0.8, n),
        delta_amb=rng.uniform(-0.01, 0.01, n),
    )
    sw = 10.0 ** rng.uniform(-28.0, -19.0, n)
    a = 10.0 ** rng.uniform(-6.0, 2.0, n)
    order = rng.permutation(n)
    mat = np.full((n, width + 1), ord(" "), dtype=np.uint8)
    mat[:, width] = ord("\n")
    _put_column(mat, 0, [f"{m:2d}" for m in mol[order]], 2)
    _put_column(mat, 2, list(iso[order]), 1)
    _put_column(mat, 15, [f"{x:10.3E}" for x in sw[order]], 10)
    _put_column(mat, 25, [f"{x:10.3E}" for x in a[order]], 10)
    for name, start, w, dec in _PAR_FIXED:
        _put_column(mat, start, _fortran_fixed(cols[name][order], w, dec), w)
    return mat.tobytes()


def ingest_geisa(n: int = GEISA_RECORDS, seed: int = INGEST_SEED) -> dict:
    """GEISA records of CO's three principal isotopologues at 1,900-2,300
    cm-1 from ``seed``, as ``format_geisa_records`` takes them."""
    from archnemesis_tpu_torch.io.hitran import radtran_to_geisa

    rng = np.random.default_rng(seed)
    mol = radtran_to_geisa(5, 1)[0]
    codes = np.array([radtran_to_geisa(5, i)[1] for i in (1, 2, 3)])
    return {
        "nu": rng.uniform(1900.0, 2300.0, n),
        "sw": 10.0 ** rng.uniform(-28.0, -19.0, n),
        "gamma_air": rng.uniform(0.04, 0.09, n),
        "elower": rng.uniform(0.0, 3000.0, n),
        "iso_code": codes[rng.integers(0, 3, n)],
        "mol_id": np.full(n, mol),
        "a_einstein": 10.0 ** rng.uniform(-4.0, 2.0, n),
        "n_air": rng.uniform(0.4, 0.9, n),
        "delta_air": rng.uniform(-0.01, 0.01, n),
        "gamma_self": np.where(np.arange(n) % 7 == 0, 0.0,
                               rng.uniform(0.05, 0.11, n)),
        "n_self": rng.uniform(0.4, 0.9, n),
    }


def ingest_exomol(out_dir: str, n_states: int = EXOMOL_STATES,
                  n_trans: int = EXOMOL_TRANS, seed: int = INGEST_SEED,
                  gz: bool = True) -> tuple:
    """Write an ExoMol triple from ``seed`` into ``out_dir``: ``n_states``
    states (the ground state at 0, the rest at 0-10,000 cm-1, g = 2J + 1
    for J 0-60), ``n_trans`` transitions between random pairs of distinct
    states (the upper the higher), the ``.trans`` gzip'd when ``gz``, and
    ``a0`` broadening for J 0-60. Returns the (states, trans, broad)
    paths."""
    import gzip

    rng = np.random.default_rng(seed)
    energy = np.concatenate([[0.0], rng.uniform(0.0, 10000.0, n_states - 1)])
    j = rng.integers(0, 61, n_states).astype(np.float64)
    ids = np.arange(1, n_states + 1)
    a = rng.integers(1, n_states + 1, n_trans)
    b = (a + rng.integers(1, n_states, n_trans) - 1) % n_states + 1
    up = np.where(energy[a - 1] > energy[b - 1], a, b)
    low = np.where(energy[a - 1] > energy[b - 1], b, a)
    paths = tuple(os.path.join(out_dir, name) for name in (
        "co.states", "co.trans.gz" if gz else "co.trans", "co.broad"))
    rows = "".join(f"{i:12d} {e:12.6f} {2 * jj + 1:6.1f} {jj:7.1f}\n"
                   for i, e, jj in zip(ids, energy, j))
    with open(paths[0], "w") as f:
        f.write(rows)
    rows = "".join(f"{u:12d} {lo:12d} {x:10.4e}\n" for u, lo, x in zip(
        up, low, 10.0 ** rng.uniform(-4.0, 2.0, n_trans))).encode()
    with (gzip.open if gz else open)(paths[1], "wb") as f:
        f.write(rows)
    with open(paths[2], "w") as f:
        f.write("".join(f"a0 {0.07 - 3e-4 * jj:.4f} {0.7 - 2e-3 * jj:.3f} "
                        f"{jj:6.1f}\n" for jj in range(61)))
    return paths


def _ingest_state():
    """(t [K], p [atm], ambient fraction): (NLAY,) float32 CUDA tensors of
    the LBL headline's 40 layers, from its forward on the card (as phase 7
    takes them; the layers do not depend on the wave grid, cut here)."""
    import torch

    from archnemesis_tpu_torch.forward import (
        ATM_TO_PA,
        forward_nadir,
        runtime_ambient_fraction,
    )
    from archnemesis_tpu_torch.synthetic import lbl_headline

    atm, laycfg, rt, surf, cfg = lbl_headline(1024, dtype=torch.float32,
                                              device="cuda")
    _, diag = forward_nadir(atm, laycfg, rt, None, None, surf, cfg,
                            emiss_ang=0.0, return_diagnostics=True,
                            device="cuda")
    layers = diag["layers"]
    return (layers.temp, layers.press / ATM_TO_PA,
            runtime_ambient_fraction(cfg, layers, 0))


def _ingest_launch(ll, blocks, state, dtype, packed=None):
    """k of one synthesis through the entry point
    (``ops/lbl.lbl_cross_section(device="cuda")``) in ``dtype``, and the
    kernel-2 launches it made (must be 1), counted from 0."""
    import torch

    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.ops.lbl import lbl_cross_section

    t, p, amb = (x.to(dtype) for x in state)
    torch.cuda.synchronize()
    lbl_cuda.lbl_cross_section.launches = 0
    k = lbl_cross_section(ll, blocks, t, p, amb, device="cuda",
                          packed=packed)
    torch.cuda.synchronize()
    launches = lbl_cuda.lbl_cross_section.launches
    if (launches != 1 or tuple(k.shape) != (blocks.n_wave, len(t))
            or not torch.isfinite(k).all() or not (k >= 0).all()
            or not (k > 0).any()):
        raise AssertionError(f"ingested synthesis: {launches} launches, "
                             f"shape {tuple(k.shape)}, not finite, "
                             "negative or all zero")
    return k, launches


def _ingest_vs_plain(ll, blocks, k32, state, what: str) -> float:
    """Kernel 2 against its plain version on the ``LBL_COMPARE_LAYERS`` of
    ``state``: the float64 kernel at ``LBL_F64_RTOL``, the main path's
    float32 result ``k32`` within ``LBL_F32_BOUNDS`` of the plain float64
    version; returns the float64 max abs error."""
    sel = list(LBL_COMPARE_LAYERS)
    t64, p64, a64 = (x[sel].double() for x in state)
    k64, plain64 = lbl_kernel_and_plain(ll, blocks, t64, p64, a64)
    _lbl_f64_check(k64, plain64, f"{what}, layers {sel}")
    _lbl_f32_check(k32[:, sel], plain64, f"{what}, layers {sel}")
    return (k64 - plain64).abs().max().item()


def _bitwise_equal(a: dict, b: dict) -> bool:
    """Two decoders' columns: the same names, types and bits."""
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k].view(np.uint8),
                                                    b[k].view(np.uint8))
        for k in a)


def _ingest_decoders(path: str, nbytes: int) -> dict:
    """Both decoders on the catalogue at ``path``: equal bit for bit, with
    their MB/s; returns the columns."""
    from archnemesis_tpu_torch.io.hitran import parse_par

    rates = {}
    for name, use_native in (("numpy", False), ("native", None)):
        t0 = time.perf_counter()
        rec = parse_par(path, use_native=use_native)
        seconds = time.perf_counter() - t0
        rates[name] = (rec, nbytes / 1e6 / seconds, seconds)
    same = _bitwise_equal(rates["numpy"][0], rates["native"][0])
    _print(f"decoders on {rates['numpy'][0]['nu'].size} records "
           f"({nbytes / 1e6:.1f} MB): " + ", ".join(
               f"{name} {mbs:.1f} MB/s ({s:.3f} s)"
               for name, (_, mbs, s) in rates.items())
           + f"; columns equal bit for bit: {same} "
           f"({'ok' if same else 'FAIL'})")
    if not same:
        raise AssertionError("the native and numpy decoders differ")
    return rates["native"][0]


def phase_ingest(card: str):
    """Phase 25: database ingestion into kernel 2 (HITRAN, GEISA, ExoMol and
    an ans store), then the profiling module around a golden-deck forward.
    Returns (kernel-2 launches, kernel-1 launches) of the main path."""
    import dataclasses

    import torch

    from archnemesis_tpu_torch.io.ansdb import AnsDatabase
    from archnemesis_tpu_torch.io.exomol import linelist_from_exomol
    from archnemesis_tpu_torch.io.geisa import (
        format_geisa_records,
        linelist_from_geisa,
        parse_geisa,
    )
    from archnemesis_tpu_torch.io.hitran import (
        TIPS_PATH,
        linelist_from_par,
        read_tips,
    )
    from archnemesis_tpu_torch.io.linedata import (
        _slice_lines,
        read_ans_linedata,
    )
    from archnemesis_tpu_torch.ops.lbl import (
        build_blocks,
        lbl_cross_section,
        lbl_cross_section_plain,
    )
    from archnemesis_tpu_torch.ops.overlap_cuda import combine_pair
    from archnemesis_tpu_torch.tools.common import median_ms
    from archnemesis_tpu_torch.utils.profiling import (
        Timings,
        annotate,
        device_memory_report,
        stopwatch,
        trace,
    )

    t_phase = time.perf_counter()
    state = _ingest_state()
    host = [x.double().cpu().numpy() for x in state]
    lbl_launches = 0

    def windowed(ll, what):
        llw = _slice_lines(ll, *INGEST_WINDOW)
        _print(f"{what}: {ll.n_lines} lines selected, {llw.n_lines} within "
               f"{INGEST_WINDOW[0]:.3f}-{INGEST_WINDOW[1]:.3f} cm-1")
        if llw.n_lines == 0:
            raise AssertionError(f"{what}: no line reaches the grid")
        return llw, build_blocks(INGEST_WAVE, llw.nu)

    with tempfile.TemporaryDirectory() as tmp:
        # --- 1. the HITRAN catalogue through both decoders
        t0 = time.perf_counter()
        buf = ingest_par()
        par = os.path.join(tmp, "catalogue.par")
        with open(par, "wb") as f:
            f.write(buf)
        _print(f"HITRAN catalogue: {INGEST_RECORDS} records, {len(buf)} "
               f"bytes, made in {time.perf_counter() - t0:.3f} s")
        rec = _ingest_decoders(par, len(buf))
        n_co = {i: int(((rec["mol_id"] == 5)
                        & (rec["local_iso_id"] == int(i))).sum())
                for i in INGEST_CO}
        iso_chars = {c: int((rec["local_iso_id"] == v).sum())
                     for c, v in (("0", 10), ("A", 11), ("B", 12))}
        if n_co != INGEST_CO or min(iso_chars.values()) == 0:
            raise AssertionError(f"decoded CO records {n_co}, iso chars "
                                 f"0/A/B {iso_chars}")
        del buf, rec

        # --- 2. HITRAN -> LineList (TIPS from the export) -> kernel 2
        ll = linelist_from_par(par, 5, 1)
        if not (np.array_equal(ll.pf_q, read_tips(TIPS_PATH, 5, 1)[1])
                and TIPS_PATH.endswith(".npz")):
            raise AssertionError("the HITRAN list's TIPS table is not the "
                                 "export's")
        llw, blocks = windowed(ll, "HITRAN CO iso 1")
        torch.cuda.reset_peak_memory_stats()
        k32, n32 = _ingest_launch(llw, blocks, state, torch.float32)
        k64, n64 = _ingest_launch(llw, blocks, state, torch.float64)
        peak = torch.cuda.max_memory_allocated() / 2**30
        lbl_launches += n32 + n64
        _print(f"HITRAN -> kernel 2 ({blocks.n_wave} waves x {llw.n_lines} "
               f"lines x {len(host[0])} layers, {blocks.n_blocks} blocks of "
               f"up to {blocks.max_lines_per_block} lines): {n32} + {n64} "
               f"launches (float32, float64), peak memory {peak:.3f} GiB")
        _ingest_vs_plain(llw, blocks, k32, state, "HITRAN list")
        # on all 40 layers: the float32 kernel against the plain float32
        # version at the float32 bound, and both against the float64 kernel
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain32 = lbl_cross_section_plain(llw, blocks, *(
            x.float() for x in state))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        _lbl_f32_check(k32, plain32, "HITRAN list, all layers, kernel vs "
                       "plain (float32)")
        want = k64.cpu().numpy()
        r_k, r_p = (rel_err(x.double().cpu().numpy(), want)
                    for x in (k32, plain32))
        _print(f"HITRAN list, all layers, against the float64 kernel: "
               f"kernel float32 max rel {r_k.max():.3e} (median "
               f"{np.median(r_k):.3e}), plain float32 max rel "
               f"{r_p.max():.3e} (median {np.median(r_p):.3e}); the plain "
               f"float32 version took {plain_ms:.3f} ms")
        del k64, plain32
        packed = {}
        for dtype, itemsize in ((torch.float32, 4), (torch.float64, 8)):
            t, p, amb = (x.to(dtype) for x in state)
            ms = median_ms(lambda: lbl_cross_section(
                llw, blocks, t, p, amb, device="cuda", packed=packed),
                reps=INGEST_KERNEL_RUNS)
            bound, by, ops = lbl_bound_ms(llw, blocks, *host,
                                          itemsize=itemsize)
            _print(f"HITRAN list, {dtype} kernel 2: median {ms:.4f} ms over "
                   f"{INGEST_KERNEL_RUNS} launches, bound {bound:.4f} ms "
                   f"({by}; {ops:.4e} operations; {ms / bound:.2f}x), "
                   f"{card}")

        # --- 3. GEISA and ExoMol -> kernel 2
        records = ingest_geisa()
        gbuf = format_geisa_records(records)
        same = _bitwise_equal(parse_geisa(gbuf, use_native=False),
                              parse_geisa(gbuf))
        if not same:
            raise AssertionError("GEISA: the decoders differ")
        geisa = os.path.join(tmp, "catalogue.geisa")
        with open(geisa, "wb") as f:
            f.write(gbuf)
        lists = {"GEISA": linelist_from_geisa(geisa, 5, 1)}
        paths = ingest_exomol(tmp)
        lists["ExoMol"] = linelist_from_exomol(paths[0], paths[1], 5, 1,
                                               broad_path=paths[2])
        _print(f"GEISA: {GEISA_RECORDS} records, decoders equal bit for "
               f"bit; ExoMol: {EXOMOL_STATES} states, {EXOMOL_TRANS} "
               f"transitions ({os.path.basename(paths[1])})")

        # --- 4. the ans store's export through AnsDatabase
        db = AnsDatabase(LINEDATA_NPZ)
        full = read_ans_linedata(LINEDATA_NPZ, 5, 1)
        smed = float(np.median(full.sw))
        strong = db.fetch_line_data(5, 1, s_min=smed)
        keep = full.sw >= smed
        for name, got, want in (
                ("windowed", db.fetch_line_data(5, 1, *INGEST_WINDOW),
                 _slice_lines(full, *INGEST_WINDOW)),
                ("s_min", strong, dataclasses.replace(
                    full, nu=full.nu[keep], sw=full.sw[keep],
                    elower=full.elower[keep], stim_ref=full.stim_ref[keep],
                    broad=full.broad[:, keep]))):
            for field in ("nu", "sw", "elower", "stim_ref", "broad",
                          "pf_temp", "pf_q"):
                if not np.array_equal(getattr(got, field),
                                      getattr(want, field)):
                    raise AssertionError(f"ans store, {name} fetch: {field} "
                                         "differs from the full read's")
        lists["ans store"] = db.fetch_line_data(5, 1, *INGEST_WINDOW)
        _print(f"ans store ({LINEDATA_NPZ}): windowed and s_min fetches "
               f"equal the full read's slices ({strong.n_lines} of "
               f"{full.n_lines} lines at s_min {smed:.3e})")

        for what, source in lists.items():
            llw, blocks = windowed(source, what)
            k32, n = _ingest_launch(llw, blocks, state, torch.float32)
            lbl_launches += n
            err_s = _ingest_vs_plain(llw, blocks, k32, state, what)
            _print(f"{what} -> kernel 2: {n} launch, float64 max abs err "
                   f"{err_s:.3e}")

    # --- 5. profiling on the card, around phase 3's golden-deck forward
    deck = golden_deck("cuda")
    deck_forward(deck, "cuda")
    reg = Timings()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    combine_pair.launches = 0
    with stopwatch("golden forward", registry=reg) as box:
        start.record()
        box[0] = deck_forward(deck, "cuda")
        end.record()
    event_ms = start.elapsed_time(end)
    wall_ms = reg.summary()["golden forward"]["total_s"] * 1e3
    _print(f"stopwatch around the golden-deck forward: {wall_ms:.3f} ms, "
           f"its CUDA events {event_ms:.3f} ms "
           f"({'ok' if wall_ms >= event_ms else 'FAIL'})")
    if wall_ms < event_ms:
        raise AssertionError("the stopwatch stopped before the device")
    logdir = os.path.join("build", "ingest_trace")
    with trace(logdir):
        with annotate("golden_forward"):
            deck_forward(deck, "cuda")
    combine_launches = combine_pair.launches
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    regions = sum(1 for e in events if e.get("name") == "golden_forward")
    combines = sum(1 for e in events if e.get("cat") == "kernel"
                   and "combine_" in e.get("name", ""))
    _print(f"trace in {logdir}: {regions} 'golden_forward' regions, "
           f"{combines} kernel-1 launches, {len(events)} events")
    if regions == 0 or combines != combine_launches // 2:
        raise AssertionError(f"trace: {regions} regions, {combines} "
                             f"combine launches of {combine_launches // 2}")
    report = device_memory_report()
    peak = torch.cuda.max_memory_allocated(0)
    got = report.get("cuda:0", {}).get("allocated_bytes.all.peak", -1)
    _print(f"device_memory_report: {sorted(report)}, cuda:0 peak {got} "
           f"bytes against max_memory_allocated {peak}")
    if got < peak:
        raise AssertionError("device_memory_report's peak is below "
                             "max_memory_allocated")
    _print(f"ingestion phase: {time.perf_counter() - t_phase:.1f} s")
    return lbl_launches, combine_launches


# --- phase 26: line-by-line at run time (ILBL = 1) through the limb, SO and
# --- transit set-ups

LBL_GEOM_EVAL_RUNS = 3
# the full-width forwards' tangent heights (km): the Mars SO run's count
# (15, mars_solocc) over the LBL headline's 0-80 km layering
LBL_GEOM_TANHE = np.linspace(5.0, 61.0, 15)


def lbl_tangent_setups() -> dict:
    """kind -> the set-up function of ``lbl_tangent_deck``'s decks."""
    from archnemesis_tpu_torch.retrievals import (
        make_retrieval_setup_limb,
        make_retrieval_setup_so,
        make_retrieval_setup_transit,
    )

    return {"limb": make_retrieval_setup_limb,
            "so": make_retrieval_setup_so,
            "transit": make_retrieval_setup_transit}


def jacobian_column_errors(k, ref) -> np.ndarray:
    """Error of each column of the Jacobian ``k`` against ``ref`` over
    that column's peak in ``ref`` (host float64 arrays)."""
    peak = np.abs(ref).max(axis=0)
    return np.abs(k - ref).max(axis=0) / np.where(peak > 0, peak, 1.0)


def plain_tangent_ms(setup, x) -> tuple:
    """(host ms spent in kernel 2's forward-mode rule, the plain version's
    ``jvp``, during one forward-plus-Jacobian evaluation; the rule's calls;
    the host ms of that whole evaluation). Each call of the rule is
    bracketed by synchronises on the card, so the evaluation is slower
    than an untimed one."""
    import torch

    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian

    rule = lbl_cuda._LblCrossSection.jvp
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    spent = []

    def timed(ctx, *tangents):
        sync()
        t0 = time.perf_counter()
        out = rule(ctx, *tangents)
        sync()
        spent.append(time.perf_counter() - t0)
        return out

    lbl_cuda._LblCrossSection.jvp = staticmethod(timed)
    t0 = time.perf_counter()
    try:
        forward_and_jacobian(setup.forward_fn, x)
        sync()
    finally:
        lbl_cuda._LblCrossSection.jvp = staticmethod(rule)
    return sum(spent) * 1e3, len(spent), (time.perf_counter() - t0) * 1e3


def _lbl_geometry_launches(fn):
    """(fn(), kernel-2 launches, kernel-1 and kernel-1t launches), the
    counts set to 0 just before ``fn()`` and read just after it."""
    import torch

    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.ops.overlap_cuda import (
        combine_pair,
        combine_pair_with_tangents,
    )

    lbl_cuda.lbl_cross_section.launches = 0
    combine_pair.launches = 0
    combine_pair_with_tangents.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return (out, lbl_cuda.lbl_cross_section.launches,
            combine_pair.launches + combine_pair_with_tangents.launches)


def _lbl_deck_case(kind: str, deck: str, card: str) -> int:
    """One ILBL = 1 tangent deck through its set-up on the card in float64
    and float32 against the port's CPU run; returns kernel 2's launches on
    the main path (one forward and one evaluation in each type)."""
    import torch

    from archnemesis_tpu_torch.io.linedata import RuntimeLBL
    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian

    make = lbl_tangent_setups()[kind]
    cpu = make(deck, "cirstest", device="cpu")
    y_cpu, k_cpu = forward_and_jacobian(cpu.forward_fn,
                                        torch.as_tensor(cpu.sv.xa))
    y_cpu, k_cpu = y_cpu.numpy(), k_cpu.numpy()
    s64 = make(deck, "cirstest", device="cuda")
    s32 = make(deck, "cirstest", device="cuda", dtype=torch.float32)
    if not isinstance(s64.deck.ktables, RuntimeLBL):
        raise AssertionError(f"{kind}: the set-up holds no RuntimeLBL")
    xa = torch.as_tensor(s64.sv.xa, device="cuda")
    nx, ny = s64.sv.nx, s64.y.shape[0]
    launches, out = 0, {}
    for name, setup, x in (("float64", s64, xa),
                           ("float32", s32, xa.float())):
        y, n_fwd, n_comb = _lbl_geometry_launches(lambda: setup.forward_fn(x))
        (yk, kk), n_eval, m_comb = _lbl_geometry_launches(
            lambda: forward_and_jacobian(setup.forward_fn, x))
        _print(f"{kind} deck ({name}): kernel 2 launched {n_fwd} time per "
               f"forward and {n_eval} per forward-plus-Jacobian evaluation, "
               f"kernels 1 and 1t {n_comb} and {m_comb} times")
        if (n_fwd, n_eval, n_comb, m_comb) != (1, 1, 0, 0):
            raise AssertionError(f"{kind} ({name}): launches {n_fwd} / "
                                 f"{n_eval} of kernel 2, {n_comb} / {m_comb} "
                                 "of kernels 1 and 1t; expected 1 / 1, 0 / 0")
        if not (torch.isfinite(yk).all() and torch.isfinite(kk).all()):
            raise AssertionError(f"{kind} ({name}): not finite")
        torch.testing.assert_close(yk, y, rtol=0, atol=0)
        launches += n_fwd + n_eval
        out[name] = (y, kk)
    y64, k64 = (t.cpu().numpy() for t in out["float64"])
    np.testing.assert_allclose(y64, y_cpu, rtol=1e-10, atol=0,
                               err_msg=f"{kind} forward")
    col_err = jacobian_column_errors(k64, k_cpu)
    if not ((np.abs(k_cpu).max(axis=0) > 0).all() and col_err.max() < 1e-10):
        raise AssertionError(f"{kind}: Jacobian columns off the CPU's by "
                             f"{col_err} of their peaks")
    _print(f"{kind} deck (ILBL = 1, NX={nx}, NY={ny}, "
           f"{len(s64.deck.ktables.wave)} waves, "
           f"{s64.deck.ktables.line_lists[0].n_lines} lines) float64 on the "
           f"card: forward within 1e-10 of the CPU's (max rel "
           f"{np.abs(y64 / y_cpu - 1).max():.3e}); every Jacobian column "
           f"within {col_err.max():.3e} of its peak (gate 1e-10)")
    y32, k32 = out["float32"]
    _lbl_f32_check(y32, out["float64"][0], f"{kind} deck spectrum")
    col_err32, misses = jacobian_column_misses(k32, out["float64"][1],
                                               s64.sv.entries)
    _print(f"{kind} deck float32 Jacobian: max error over column peak "
           f"{col_err32.max():.3e} (gate {JAC_F32_BOUND:.0e}); columns "
           f"outside the gate: {misses if misses else 'none'}; columns "
           f"whose float64 peak float32 cannot hold: "
           f"{float32_unheld_columns(out['float64'][1])}")
    if misses:
        raise AssertionError(f"{kind}: float32 Jacobian columns outside "
                             f"{JAC_F32_BOUND:.0e}: {misses}")
    del out
    for name, setup, x in (("float64", s64, xa),
                           ("float32", s32, xa.float())):
        med, lo, hi, peak = _time_jacobians(setup, x, LBL_GEOM_EVAL_RUNS)
        tan_ms, tan_calls, total = plain_tangent_ms(setup, x)
        _print(f"forward-plus-Jacobian of the {kind} deck ({name}, {card}): "
               f"median {med:.3f} ms over {LBL_GEOM_EVAL_RUNS} runs (min "
               f"{lo:.3f}, max {hi:.3f}); peak memory {peak:.3f} GiB; kernel "
               f"2's plain-version tangent {tan_ms:.3f} ms in {tan_calls} "
               f"call(s) of an evaluation timed with it, {total:.3f} ms "
               f"({tan_ms / total:.1%})")
    return launches


def with_optical_depths(taugas, fn):
    """``fn()`` with every runtime line-by-line synthesis replaced by the
    gas optical depths ``taugas`` (NWAVE, 1, NLAY): the forward's radiative
    transfer on given opacities (no kernel launch)."""
    from archnemesis_tpu_torch import forward as forward_module

    synthesis = forward_module.runtime_lbl_tau
    forward_module.runtime_lbl_tau = lambda *args: taugas
    try:
        return fn()
    finally:
        forward_module.runtime_lbl_tau = synthesis


def lbl_geometry_f32_errors(fwd, deck32, deck64) -> dict:
    """The float32 errors of a geometry forward ``fwd(atm, rt, cfg,
    return_diagnostics=True)`` against its float64 forward on the same
    inputs: "spectrum" (end to end), "transfer" (the float32 forward on the
    float64 forward's gas optical depths: the radiative transfer alone),
    "taugas" (the float32 synthesis's optical depths on
    ``LBL_COMPARE_LAYERS``, phase 7's layers) and "taugas, all layers",
    each (max, median) of ``rel_err``."""
    atm32, _, rt32, _, cfg32 = deck32
    atm64, _, rt64, _, cfg64 = deck64
    spec64, d64 = fwd(atm64, rt64, cfg64)
    spec32, d32 = fwd(atm32, rt32, cfg32)
    moved, _ = with_optical_depths(d64["taugas"].float(),
                                   lambda: fwd(atm32, rt32, cfg32))
    lay = list(LBL_COMPARE_LAYERS)
    pairs = {"spectrum": (spec32, spec64), "transfer": (moved, spec64),
             "taugas": (d32["taugas"][..., lay], d64["taugas"][..., lay]),
             "taugas, all layers": (d32["taugas"], d64["taugas"])}
    out = {}
    for name, (a, b) in pairs.items():
        r = rel_err(a.double().cpu().numpy(), b.cpu().numpy())
        out[name] = (float(r.max()), float(np.median(r)))
    return out


def _tangent_layering_kernel(deck, card: str) -> float:
    """Kernel 2 alone on the layering every tangent forward synthesises on
    (90 degrees) of the LBL headline ``deck`` (float32): its mean time over
    ``LBL_KERNEL_RUNS`` launches (CUDA events) beside its bound; returns
    the time in ms."""
    from archnemesis_tpu_torch.forward import (
        ATM_TO_PA,
        runtime_ambient_fraction,
    )
    from archnemesis_tpu_torch.ops.lbl import lbl_cross_section
    from archnemesis_tpu_torch.rt.layer import build_layers

    atm, laycfg, rt, _, cfg = deck
    layers = build_layers(atm, laycfg, layang=90.0)
    state = (layers.temp, layers.press / ATM_TO_PA,
             runtime_ambient_fraction(cfg, layers, 0))
    ll, blocks = rt.line_lists[0], rt.blocks[0]
    opts = dict(lineshape=rt.lineshape[0], s_floor=rt.s_floor[0],
                wn_calc_window=rt.wn_calc_window[0],
                wn_approx_window=rt.wn_approx_window[0],
                include_pressure_shift=rt.include_pressure_shift[0])
    ms = _cuda_ms(lambda: lbl_cross_section(
        ll, blocks, *state, device="cuda", packed=rt.packed_inputs(0),
        **opts), reps=LBL_KERNEL_RUNS)
    host = [x.double().cpu().numpy() for x in state]
    bound_ms, bound_by, _ = lbl_bound_ms(ll, blocks, *host, itemsize=4)
    _print(f"kernel 2 on the tangent layering ({blocks.n_wave} waves x "
           f"{ll.n_lines} lines x {laycfg.nlay} layers at 90 degrees, "
           f"float32, {card}): {ms:.4f} ms (mean of {LBL_KERNEL_RUNS}) "
           f"beside its bound {bound_ms:.4f} ms ({bound_by}), "
           f"{ms / bound_ms:.2f}x")
    return ms


def _lbl_geometry_headline(card: str, profile: bool = False) -> int:
    """The LBL headline (``synthetic.lbl_headline``) through ``forward_so``
    and ``forward_limb_batch`` over ``LBL_GEOM_TANHE`` and through
    ``forward_transit`` over every layer base; returns kernel 2's launches
    on the main path (one forward each).

    Float32 against the float64 forward of the same call: the radiative
    transfer (on the float64 optical depths) and the synthesis (on phase
    7's layers) each within ``LBL_F32_BOUNDS``, and the transit depth end
    to end. The limb and SO spectra end to end are printed beside: a
    transmission exp(-tau) carries tau times the synthesis's relative
    error, and a thin limb radiance the synthesis's error at the top
    layers, where float32's far-wing Voigt loses relative accuracy.
    ``profile``: ``profile_forward`` of each forward."""
    import torch

    from archnemesis_tpu_torch.forward import (
        forward_limb_batch,
        forward_so,
        forward_transit,
        so_geometry,
    )
    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.rt.layer import build_layers
    from archnemesis_tpu_torch.rt.path import limb_paths
    from archnemesis_tpu_torch.synthetic import LBL_NWAVE, lbl_headline

    decks = {dt: lbl_headline(dtype=dt, device="cuda")
             for dt in (torch.float32, torch.float64)}
    atm64, laycfg = decks[torch.float64][:2]
    # the stencil from the float64 layering, for both types
    geo_so = so_geometry(atm64, laycfg, LBL_GEOM_TANHE)
    geo_limb = so_geometry(atm64, laycfg, LBL_GEOM_TANHE, lfm_bracket=True)
    forwards = {
        "forward_so": lambda atm, rt, cfg, **kw: forward_so(
            atm, laycfg, rt, None, None, cfg, geo_so, device="cuda", **kw),
        "forward_limb_batch": lambda atm, rt, cfg, **kw: forward_limb_batch(
            atm, laycfg, rt, None, None, cfg, geo_limb, device="cuda", **kw),
        "forward_transit": lambda atm, rt, cfg, **kw: forward_transit(
            atm, laycfg, rt, None, None, cfg,
            stellar_radius_km=LBL_GEOM_STELLAR_KM, device="cuda", **kw),
    }
    # each forward's tangent (bottom) layers, one path each
    paths = {"forward_so": list(geo_so["itanhe"]),
             "forward_limb_batch": list(geo_limb["itanhe"]),
             "forward_transit": list(range(laycfg.nlay - 1))}
    nlines = decks[torch.float32][2].line_lists[0].n_lines
    kernel_ms = _tangent_layering_kernel(decks[torch.float32], card)
    launches = 0
    for name, fwd in forwards.items():
        atm, _, rt, _, cfg = decks[torch.float32]

        def forward():
            return fwd(atm, rt, cfg)

        spec, n_lbl, n_comb = _lbl_geometry_launches(forward)
        if (n_lbl, n_comb) != (1, 0):
            raise AssertionError(f"{name}: {n_lbl} kernel-2 and {n_comb} "
                                 "kernel-1 launches, expected 1 and 0")
        if not torch.isfinite(spec).all() or spec.shape[0] != LBL_NWAVE:
            raise AssertionError(f"{name}: spectrum not finite or not "
                                 f"{LBL_NWAVE} waves")
        launches += n_lbl
        del spec
        torch.cuda.reset_peak_memory_stats()
        packs = lbl_cuda.kernel_inputs.calls
        times = []
        for i in range(HEADLINE_RUNS + 2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            forward()
            end.record()
            end.synchronize()
            if i >= 2:
                times.append(start.elapsed_time(end))
        packs = lbl_cuda.kernel_inputs.calls - packs
        if packs:
            raise AssertionError(f"{name}: the static kernel inputs were "
                                 f"packed {packs} times after the first "
                                 "forward")
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = float(np.median(times))
        # the host's launches: the forward's tensor operations, and those
        # of its path geometry alone (one layering at 90 degrees)
        _, n_ops = _count_ops(forward)
        layers = build_layers(atm, laycfg, layang=90.0)
        _, n_path_ops = _count_ops(lambda: limb_paths(
            layers, atm.radius, atm.h[-1], paths[name]))
        _print(f"{name} on the LBL headline ({LBL_NWAVE} waves x {nlines} "
               f"lines x {laycfg.nlay} layers, {len(paths[name])} paths, "
               f"float32, {card}): median {ms:.3f} ms over {len(times)} "
               f"runs (min {min(times):.3f}, max {max(times):.3f}); "
               f"{LBL_NWAVE / ms * 1e3:.1f} waves/s; peak memory "
               f"{peak:.3f} GiB; 1 kernel-2 launch per forward, no packing "
               f"after the first; kernel 2 alone {kernel_ms / ms:.1%} of it; "
               f"{n_ops} tensor operations per forward, {n_path_ops} of them "
               f"in the path geometry (limb_paths)")
        errs = lbl_geometry_f32_errors(
            lambda *a: fwd(*a, return_diagnostics=True),
            decks[torch.float32], decks[torch.float64])
        _print(f"{name} float32 vs float64 (max, median rel): " + "; ".join(
            f"{k} {v[0]:.3e}, {v[1]:.3e}" for k, v in errs.items()))
        gated = ["transfer", "taugas"] + (
            ["spectrum"] if name == "forward_transit" else [])
        bad = [k for k in gated if not (errs[k][0] < LBL_F32_BOUNDS[0]
                                        and errs[k][1] < LBL_F32_BOUNDS[1])]
        if bad:
            raise AssertionError(f"{name}: float32 {bad} outside "
                                 f"{LBL_F32_BOUNDS[0]:.0e} / "
                                 f"{LBL_F32_BOUNDS[1]:.0e}")
        if profile:
            profile_forward(forward, what=f"{name} on the LBL headline",
                            trace=f"build/{name}_trace.json")
        torch.cuda.empty_cache()
    return launches


def phase_lbl_geometries(card: str, profile: bool = False) -> int:
    """Phase 26: line-by-line at run time (ILBL = 1) through the limb, SO
    and transit set-ups on kernel 2; returns its launches on the main
    paths. ``profile``: device time by kernel of the full-width
    forwards."""
    from archnemesis_tpu_torch.retrievals import retrieval_nemesis

    launches = 0
    with tempfile.TemporaryDirectory() as base:
        for kind in LBL_TANGENT_DECKS:
            deck = lbl_tangent_deck(base, kind)
            launches += _lbl_deck_case(kind, deck, card)
        t0 = time.perf_counter()
        res = retrieval_nemesis(os.path.join(base, "so"), "cirstest",
                                nemesis_so=True, niter=3, write_outputs=False,
                                device="cuda")
        wall = time.perf_counter() - t0
    if not (np.all(np.isfinite(res.xn))
            and res.phi_history[-1] < res.phi_history[0]):
        raise AssertionError(f"ILBL = 1 SO retrieval: phi {res.phi_history}")
    _print(f"retrieval_nemesis(nemesis_so=True, niter=3) on the ILBL = 1 SO "
           f"deck ({card}): {wall:.3f} s, phi {res.phi_history[0]:.6e} -> "
           f"{res.phi_history[-1]:.6e}")
    launches += _lbl_geometry_headline(card, profile=profile)
    if "h5py" in sys.modules:
        raise AssertionError("phase 26 imported h5py")
    return launches


# --- phase 27: the correlated-k Jacobian's tangent passes

JAC_SCALED_GASES = (2, 3, 4, 5, 6)  # jupiter_ck_oe's scaled gases
TANGENT_RUNS = 5


def gas_tau_tangent_bound_ms(elems: int, n_tan: int, itemsize: int) -> float:
    """Least time of one ``gas_tau_tangent`` on an H100: its three factors
    read and its ``n_tan`` tangents written (elements x itemsize each; the
    coefficients are a few kB) over HBM bandwidth."""
    return (3 + n_tan) * elems * itemsize / PEAK_BYTES_S * 1e3


def skip_rows_bound_ms(rows: int, skipped: int, ng: int, n_tan: int,
                       itemsize: int) -> float:
    """Least time of one ``skip_rows_`` on an H100: two flag bytes a row
    read, and each skipped row's ``n_tan`` x NG values read and written."""
    return ((2 * rows + 2 * skipped * n_tan * ng * itemsize)
            / PEAK_BYTES_S * 1e3)


def headline_jacobian(dtype, device, nwave: int = 8192):
    """(fn, x): the headline deck's spectrum as a function of the
    Jacobian cell's state, the level temperatures then a scale of each of
    ``JAC_SCALED_GASES``' VMR profiles, at the deck's own state (scales
    1)."""
    import dataclasses

    import torch

    from archnemesis_tpu_torch.forward import forward_nadir
    from archnemesis_tpu_torch.synthetic import headline_deck

    atm, laycfg, ktab, surf, cfg = headline_deck(nwave, dtype=dtype,
                                                 device=device)
    nlev, ngas = atm.vmr.shape
    scaled = torch.zeros(ngas, len(JAC_SCALED_GASES), dtype=dtype,
                         device=device)
    scaled[list(JAC_SCALED_GASES), range(len(JAC_SCALED_GASES))] = 1.0
    fixed = 1.0 - scaled.sum(dim=1)

    def fn(x):
        scale = fixed + scaled @ x[nlev:]
        state = dataclasses.replace(atm, t=x[:nlev],
                                    vmr=atm.vmr * scale[None, :])
        return forward_nadir(state, laycfg, ktab, None, None, surf, cfg,
                             emiss_ang=0.0, device=device)[:, 0]

    x = torch.cat([atm.t, atm.t.new_ones(len(JAC_SCALED_GASES))])
    return fn, x


# each float32 tangent of the emission within this share of its peak in
# the float64 plain version: a slab's 1,420 products summed in float32 in
# two orders (the plain version's contraction, the kernel's lanes and
# warp tree), and the recurrences' exponentials, a few eps of float32 each
EMISSION_F32_REL = 2e-5


def limb_layers(nlay: int, tangents) -> tuple:
    """(layinc, mask) of limb paths down to each tangent layer and back up,
    padded with masked entries to the longest path."""
    rows = [list(range(nlay - 1, k - 1, -1)) + list(range(k, nlay))
            for k in tangents]
    nlayin = max(len(r) for r in rows)
    layinc = np.zeros((nlayin, len(rows)), dtype=np.int64)
    mask = np.zeros((nlayin, len(rows)))
    for p, r in enumerate(rows):
        layinc[:len(r), p] = r
        mask[:len(r), p] = 1.0
    return layinc, mask


def emission_tangent_case(dtype, device, kind="nadir", nwave=8192, ng=20,
                          nlay=71, n_tan=86, nloc=None, seed=24) -> dict:
    """Keyword inputs of ``ops/tangent_cuda.py:emission_tangent`` at the
    layout the forward gives (the Jacobian cell's shape by default): tau a
    (B, NWAVE, NG, NLAY) view of (B, NWAVE, NLAY, NG) memory, its tangent a
    view of (T, B, NWAVE, NLAY, NG) memory, optical depths growing with
    depth; ``kind`` "nadir" (one path, the ground seen) or "limb" (three
    paths down to layers 0, NLAY/3 and NLAY/2, masked tails, no ground);
    with ``nloc`` locations, each with its own paths."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape, low=0.0, high=1.0):
        return low + (high - low) * torch.rand(*shape, generator=g,
                                                device=device, dtype=dtype)

    nb = 1 if nloc is None else nloc
    if kind == "limb":
        layinc, mask = limb_layers(nlay, [0, nlay // 3, nlay // 2])
    else:
        layinc = np.arange(nlay - 1, -1, -1, dtype=np.int64)[:, None]
        mask = np.ones((nlay, 1))
    layinc, mask = np.tile(layinc, (1, nb)), np.tile(mask, (1, nb))
    nlayin, npath = layinc.shape
    depth = torch.exp(torch.linspace(-6.0, 3.0, nlay, device=device,
                                     dtype=dtype))
    tau = (depth[:, None] * draw(nb, nwave, nlay, ng)).transpose(-1, -2)
    dtau = draw(n_tan, nb, nwave, nlay, ng, low=-1.0).transpose(-1, -2)
    ground = (None if kind == "limb"
              else draw(nwave, npath, low=1e-7, high=4e-7))
    return dict(
        tau=tau, dtau=dtau,
        layinc=torch.as_tensor(layinc, device=device),
        mask=torch.as_tensor(mask, dtype=dtype, device=device),
        scale=draw(nlayin, npath, low=1.0, high=2.0),
        emtemp=draw(nlayin, npath, low=110.0, high=290.0),
        ground=ground,
        dground=None if ground is None else draw(n_tan, nwave, npath,
                                                 low=-1e-8, high=1e-8),
        wave=torch.linspace(250.0, 1400.0, nwave, device=device,
                            dtype=dtype),
        del_g=torch.as_tensor(gauss_del_g(ng), dtype=dtype, device=device),
        dscale=draw(n_tan, nlayin, npath, low=-0.1, high=0.1),
        demtemp=draw(n_tan, nlayin, npath, low=-1.0, high=1.0),
        loc=None if nloc is None else torch.arange(nloc, device=device),
        group=npath // nb)


def emission_tangent_errors(got, ref) -> float:
    """Largest error of a tangent over that tangent's peak in ``ref``."""
    peak = ref.abs().amax(dim=(1, 2))
    return ((got.double() - ref).abs().amax(dim=(1, 2)) / peak).max().item()


def emission_tangent_bound_ms(kw: dict) -> float:
    """Least time of one ``emission_tangent`` on an H100: its inputs read
    once (the optical-depth tangent leads; the primal, the paths and their
    tangents, the ground's) and its (T, NWAVE, NPATH) output written, over
    HBM bandwidth."""
    n_tan, nwave, npath = kw["dtau"].shape[0], kw["wave"].shape[0], \
        kw["layinc"].shape[1]
    elems = sum(x.numel() for k, x in kw.items()
                if k not in ("loc", "group") and x is not None)
    return ((elems + n_tan * nwave * npath) * kw["tau"].element_size()
            / PEAK_BYTES_S * 1e3)


def _gas_tau_tangent_case(dtype, n_batch: int, n_tan: int, seed: int):
    """Kernel against plain on card tensors of the evaluation's shape:
    (max abs error, max error over its bound's scale, kernel ms, plain
    ms, bound ms)."""
    import torch

    from archnemesis_tpu_torch.ops.tangent_cuda import (
        gas_tau_tangent,
        gas_tau_tangent_plain,
    )
    from archnemesis_tpu_torch.synthetic import NG, NLAY, NWAVE

    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=dtype)

    ins = ([draw(n_batch, NWAVE, NLAY, NG) for _ in range(3)]
           + [draw(n_tan, n_batch, NLAY) for _ in range(3)])
    got = gas_tau_tangent(*ins)
    want = gas_tau_tangent_plain(*ins)
    # each element's error within 4 eps of its three terms' magnitudes:
    # the kernel's fused multiply-adds round apart from addcmul's
    diff = (got - want).abs()
    del got, want
    scale = gas_tau_tangent_plain(*(x.abs() for x in ins))
    ratio = (diff / (torch.finfo(dtype).eps * scale)).nan_to_num().max()
    err = diff.max().item()
    del diff, scale
    if not ratio.item() <= 4.0:
        raise AssertionError(f"gas_tau_tangent {dtype} B = {n_batch}: "
                             f"{ratio.item():.3f} eps of its scale off plain")
    ms = _cuda_ms(lambda: gas_tau_tangent(*ins), reps=TANGENT_RUNS)
    plain_ms = _cuda_ms(lambda: gas_tau_tangent_plain(*ins),
                        reps=TANGENT_RUNS)
    bound = gas_tau_tangent_bound_ms(ins[0].numel(), n_tan,
                                     ins[0].element_size())
    return err, ratio.item(), ms, plain_ms, bound


def phase_tangent_passes(card: str) -> dict:
    """Phase 27: the correlated-k Jacobian's tangent passes at full width.
    Returns the kernels line's records of ``gas_tau_tangent`` and
    ``skip_rows_``."""
    import torch

    from archnemesis_tpu_torch.ops import tangent_cuda
    from archnemesis_tpu_torch.ops.overlap_cuda import (
        combine_pair_with_tangents,
    )
    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
    from archnemesis_tpu_torch.synthetic import NG, NLAY, NWAVE

    fn, x = headline_jacobian(torch.float32, "cuda")
    tangent_cuda.gas_tau_tangent.launches = 0
    tangent_cuda.skip_rows_.launches = 0
    tangent_cuda.emission_tangent.launches = 0
    y, kk = forward_and_jacobian(fn, x)
    torch.cuda.synchronize()
    launches = (tangent_cuda.gas_tau_tangent.launches,
                tangent_cuda.skip_rows_.launches,
                tangent_cuda.emission_tangent.launches)
    _, fused = _fused_launches(lambda: forward_and_jacobian(fn, x))
    nx = x.shape[0]
    if (launches != (7, 6, 1) or fused != 6 or kk.shape != (NWAVE, nx)
            or not (torch.isfinite(kk).all() and torch.isfinite(y).all())):
        raise AssertionError(f"Jacobian of the headline: launches "
                             f"{launches} and {fused} fused, K "
                             f"{tuple(kk.shape)}")
    del y, kk
    ms = _timed(lambda: forward_and_jacobian(fn, x), TANGENT_RUNS)
    _print(f"forward_and_jacobian of the headline (NX = {nx}, {NWAVE} "
           f"waves x {NG} g x {NLAY} layers x 7 gases, float32, {card}): "
           f"{launches[0]} gas_tau_tangent, {launches[1]} skip_rows_, "
           f"{launches[2]} emission_tangent and {fused} kernel-1t launches; "
           f"median {ms[0]:.3f} ms over {TANGENT_RUNS} runs (min "
           f"{ms[1]:.3f}, max {ms[2]:.3f}), peak memory {ms[3]:.3f} GiB")
    del fn, x
    torch.cuda.empty_cache()

    records = {}
    for dtype, n_batch, n_tan in ((torch.float32, 1, nx),
                                  (torch.float64, 1, nx),
                                  (torch.float32, 2, 16)):
        err, ratio, k_ms, plain_ms, bound = _gas_tau_tangent_case(
            dtype, n_batch, n_tan, seed=27)
        _print(f"gas_tau_tangent vs plain ({n_batch} x {NWAVE} x {NLAY} x "
               f"{NG}, {n_tan} tangents, {dtype}): max_abs_err={err:.3e}, "
               f"{ratio:.3f} eps of the terms' magnitudes (bound 4); "
               f"kernel {k_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
               f"{bound:.4f} ms (bytes; {k_ms / bound:.2f}x)")
        if (dtype, n_batch) == (torch.float32, 1):
            records["gas_tau_tangent"] = dict(
                launches=launches[0], max_abs_err=err, ms=k_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=None)
        torch.cuda.empty_cache()

    rows = NWAVE * NLAY
    g = torch.Generator(device="cuda").manual_seed(28)
    dout, da, db = (torch.randn(nx, rows, NG, generator=g, device="cuda")
                    for _ in range(3))
    idx = torch.arange(rows, device="cuda")
    skip_a, skip_b = idx % 7 == 0, idx % 5 == 0
    want = tangent_cuda.skip_rows_plain(dout, da, db, skip_a, skip_b)
    got = tangent_cuda.skip_rows_(dout, da, db, skip_a, skip_b)
    if not (got is dout and torch.equal(got, want)):
        raise AssertionError("skip_rows_ off its plain version")
    del want
    skipped = int((skip_a | skip_b).sum())
    k_ms = _cuda_ms(lambda: tangent_cuda.skip_rows_(dout, da, db, skip_a,
                                                    skip_b),
                    reps=TANGENT_RUNS)
    plain_ms = _cuda_ms(lambda: tangent_cuda.skip_rows_plain(
        dout, da, db, skip_a, skip_b), reps=TANGENT_RUNS)
    bound = skip_rows_bound_ms(rows, skipped, NG, nx, 4)
    none = torch.zeros_like(skip_a)
    none_ms = _cuda_ms(lambda: tangent_cuda.skip_rows_(dout, da, db, none,
                                                       none),
                       reps=TANGENT_RUNS)
    _print(f"skip_rows_ vs plain (R = {rows}, NG = {NG}, T = {nx}, "
           f"float32, {skipped} rows skipped): equal bits; kernel "
           f"{k_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
           f"(bytes; {k_ms / bound:.2f}x); with no row skipped {none_ms:.4f}"
           f" ms")
    records["skip_rows_"] = dict(
        launches=launches[1], max_abs_err=0.0, ms=k_ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by="bytes", library_ms=None)
    del dout, da, db
    torch.cuda.empty_cache()
    records["emission_tangent"] = _emission_tangent_gate(card, launches[2])
    return records


def _emission_tangent_gate(card: str, launches: int) -> dict:
    """``emission_tangent`` at the Jacobian cell's width in float32 against
    the plain version in float64 (and in float32, printed), timed beside
    the plain version in float32 and its bound."""
    import torch

    from archnemesis_tpu_torch.ops.tangent_cuda import (
        emission_tangent,
        emission_tangent_plain,
    )

    kw = emission_tangent_case(torch.float32, "cuda")
    before = emission_tangent.launches
    got = emission_tangent(**kw)
    torch.cuda.synchronize()
    if emission_tangent.launches != before + 1:
        raise AssertionError("emission_tangent: not one launch")
    plain32 = emission_tangent_plain(**kw)
    kw64 = {k: (v.double() if isinstance(v, torch.Tensor)
                and v.is_floating_point() else v) for k, v in kw.items()}
    ref = emission_tangent_plain(**kw64)
    del kw64
    err = emission_tangent_errors(got, ref)
    err_plain = emission_tangent_errors(plain32, ref)
    max_abs = (got.double() - ref).abs().max().item()
    del got, plain32, ref
    torch.cuda.empty_cache()
    if not err < EMISSION_F32_REL:
        raise AssertionError(f"emission_tangent float32: {err:.3e} of a "
                             f"tangent's peak off the float64 plain version "
                             f"(gate {EMISSION_F32_REL:.0e})")
    ms = _cuda_ms(lambda: emission_tangent(**kw), reps=TANGENT_RUNS)
    plain_ms = _cuda_ms(lambda: emission_tangent_plain(**kw),
                        reps=TANGENT_RUNS)
    bound = emission_tangent_bound_ms(kw)
    n_tan, _, nwave, ng, nlay = kw["dtau"].shape
    _print(f"emission_tangent vs plain (T = {n_tan}, {nwave} waves x {ng} "
           f"g x {nlay} layers, float32, {card}): {err:.3e} of a tangent's "
           f"peak off the float64 plain version (gate "
           f"{EMISSION_F32_REL:.0e}; the float32 plain version "
           f"{err_plain:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
           f"bound {bound:.4f} ms (bytes; {ms / bound:.2f}x)")
    return dict(launches=launches, max_abs_err=max_abs, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=None)


LAYER_GRAPH_RUNS = 20
# viewing geometries (emission, solar, azimuth angles) of one atmosphere,
# more than the runner keeps layouts (``rt/layer_graph.py:KEPT``)
LAYER_GRAPH_GEOMETRIES = [(5.0 * i, 180.0 - 3.0 * i, 10.0 * i)
                          for i in range(12)]


def layer_graph_case(name: str):
    """(Atmosphere, LayerConfig) of a synthetic headline, float32 on the
    card ("headline": 81 levels into 71 layers, 7 gases, the layout of the
    benchmark's jupiter_ck; "lbl": 41 levels into 40 layers, 2 gases, that
    of co_lbl), and a function of i giving the i-th state's atmosphere."""
    import dataclasses

    import torch

    from archnemesis_tpu_torch.synthetic import headline_deck, lbl_headline

    make = headline_deck if name == "headline" else lbl_headline
    atm, cfg = make(nwave=64, dtype=torch.float32, device="cuda")[:2]
    x = torch.linspace(0.0, 1.0, atm.h.shape[0], device="cuda")

    def state(i):
        return dataclasses.replace(
            atm, t=atm.t + 4.0 * torch.sin((i % 7 + 1.0) * x),
            vmr=atm.vmr * torch.exp(0.2 * torch.cos((i % 5 + 1.0) * x))[
                :, None])

    return atm, cfg, state


def _layer_timed(run, states) -> tuple:
    """Median host ms (the launching) and stream ms (CUDA events) of
    ``run(atm)`` over ``states``, and the outputs."""
    import torch

    host, stream, outs = [], [], []
    for atm in states:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = run(atm)
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        stream.append(start.elapsed_time(end))
        outs.append(out)
    return float(np.median(host)), float(np.median(stream)), outs


def _layer_bits_equal(a, b) -> bool:
    import dataclasses

    import torch

    return all(torch.equal(getattr(x, f.name), getattr(y, f.name))
               for x, y in zip(a, b) for f in dataclasses.fields(x)
               if isinstance(getattr(x, f.name), torch.Tensor))


def _eager_layering(atm, cfg, angles=(0.0, 180.0, 0.0)):
    """The nadir forward's layering and path, eagerly."""
    from archnemesis_tpu_torch.enums import PathCalc
    from archnemesis_tpu_torch.forward import apply_dust_renorm
    from archnemesis_tpu_torch.rt.layer import build_layers
    from archnemesis_tpu_torch.rt.path import nadir_path

    emiss_ang, sol_ang, azi_ang = angles
    layers = apply_dust_renorm(build_layers(atm, cfg, layang=0.0), atm)
    return layers, nadir_path(layers, atm.radius, atm.h[-1], emiss_ang,
                              sol_ang=sol_ang, azi_ang=azi_ang,
                              imod=PathCalc.THERMAL_EMISSION)


def phase_layer_graph() -> dict:
    """Phase 28: the layering and path eager and replayed from CUDA graphs
    at both forward cells' layouts; then the headline's forwards over
    ``LAYER_GRAPH_GEOMETRIES``. Returns {case: (eager host, eager stream,
    graph host, graph stream, first graphed call) ms}."""
    import torch

    from archnemesis_tpu_torch.forward import forward_nadir
    from archnemesis_tpu_torch.rt.layer_graph import layering_and_path
    from archnemesis_tpu_torch.synthetic import headline_deck

    def counts():
        return (layering_and_path.captures, layering_and_path.replays,
                layering_and_path.eager)

    out = {}
    for name in ("headline", "lbl"):
        atm, cfg, state = layer_graph_case(name)

        def graphed(atm):
            return layering_and_path(atm, cfg, 0.0, 180.0, 0.0, own=True)

        before = counts()
        _eager_layering(atm, cfg)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphed(atm)  # the capture, unless an earlier phase made it
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        states = [state(i) for i in range(LAYER_GRAPH_RUNS)]
        e_host, e_stream, e_out = _layer_timed(
            lambda a: _eager_layering(a, cfg), states)
        g_host, g_stream, g_out = _layer_timed(graphed, states)
        same = all(_layer_bits_equal(e, g) for e, g in zip(e_out, g_out))
        # an earlier phase may have captured this layout (phase 4's
        # headline lays out the same atmosphere)
        captured, replayed, eager = np.subtract(counts(), before)
        if (not same or captured > 1 or eager
                or replayed != LAYER_GRAPH_RUNS + 1):
            raise AssertionError(f"layer graph at {name}: bits equal {same}, "
                                 f"{captured} captures, {replayed} replays, "
                                 f"{eager} eager")
        _print(f"layering and path at the {name} layout ({cfg.nlay} layers "
               f"x {cfg.nint} samples x {atm.vmr.shape[1]} gases, float32, "
               f"median of {LAYER_GRAPH_RUNS} states): eager host "
               f"{e_host:.3f} ms, stream {e_stream:.3f} ms; graph replay "
               f"host {g_host:.3f} ms, stream {g_stream:.3f} ms; replayed "
               "layers and path equal the eager ones bit for bit; the "
               f"first graphed call {first_ms:.1f} ms ({captured} "
               "capture)")
        out[name] = (e_host, e_stream, g_host, g_stream, first_ms)

    # a retrieval's forwards: one atmosphere, many viewing geometries
    atm, laycfg, ktab, surf, cfg = headline_deck(nwave=64,
                                                 dtype=torch.float32,
                                                 device="cuda")
    before = counts()
    same = True
    for angles in LAYER_GRAPH_GEOMETRIES * 2:
        _, diag = forward_nadir(atm, laycfg, ktab, None, None, surf, cfg,
                                *angles, return_diagnostics=True,
                                device="cuda")
        same &= _layer_bits_equal((diag["layers"], diag["path"]),
                                  _eager_layering(atm, laycfg, angles))
    captured, replayed, eager = np.subtract(counts(), before)
    if (not same or captured > 1 or eager
            or replayed != 2 * len(LAYER_GRAPH_GEOMETRIES)):
        raise AssertionError(f"layer graph over viewing geometries: bits "
                             f"equal {same}, {captured} captures, "
                             f"{replayed} replays, {eager} eager")
    _print(f"headline forwards over {len(LAYER_GRAPH_GEOMETRIES)} viewing "
           f"geometries, twice: {captured} capture, {replayed} replays, "
           "layers and path equal the eager ones bit for bit")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    card = phase_build()
    record = phase_kernel_vs_plain()
    phase_golden_deck()
    profile = "--profile" in sys.argv[1:]
    launches, _ = phase_headline(profile=profile)
    tan_record = phase_tangent_kernel_vs_plain()
    tan_launches = phase_retrieval(profile=profile)
    lbl_record = phase_lbl_kernel_vs_plain()
    phase_lbl_golden_deck()
    lbl_launches, _ = phase_lbl_headline(profile=profile)
    phase_lbl_retrieval()
    fma_record = phase_fma_peak()
    variant_records = phase_overlap_variants()
    packed_record = phase_sharded_lbl(profile=profile)
    phase_distributed()
    phase_scattering_goldens()
    scat_launches, _ = phase_scattering_headline(profile=profile)
    scat_tan_launches = phase_scattering_retrieval(profile=profile)
    model_launches, model_tan_launches = phase_models(card, profile=profile)
    geom_launches, geom_tan_launches = phase_geometries(card)
    ns_launches = phase_nested(card)
    phase_occultation(card)
    table_launches, _ = phase_tablegen(card)
    em_launches, em_tan_launches = phase_emissions(card)
    tl_launches, tl_tan_launches = phase_telluric_multiloc(card)
    ingest_launches, ingest_combine_launches = phase_ingest(card)
    geom_lbl_launches = phase_lbl_geometries(card, profile=profile)
    tangent_records = phase_tangent_passes(card)
    phase_layer_graph()

    kernels = [dict(
        name="overlap_combine",
        route="cuda",
        source="archnemesis_tpu_torch/csrc/overlap_combine.cu",
        replaces="archnemesis_tpu/ops/overlap_pallas.py:398",
        launches=(launches + scat_launches + model_launches + geom_launches
                  + ns_launches + em_launches + tl_launches
                  + ingest_combine_launches),
        max_abs_err=record["max_abs_err"],
        ms=record["ms"],
        plain_ms=record["plain_ms"],
        bound_ms=record["bound_ms"],
        bound_by=record["bound_by"],
        library_ms=None,
    ), dict(
        name="overlap_combine_tan",
        route="cuda",
        source="archnemesis_tpu_torch/csrc/overlap_combine.cu",
        replaces="archnemesis_tpu/ops/overlap_pallas.py:292",
        launches=(tan_launches + scat_tan_launches + model_tan_launches
                  + geom_tan_launches + em_tan_launches + tl_tan_launches),
        max_abs_err=tan_record["max_abs_err"],
        ms=tan_record["ms"],
        plain_ms=tan_record["plain_ms"],
        bound_ms=tan_record["bound_ms"],
        bound_by=tan_record["bound_by"],
        library_ms=None,
    ), dict(
        name="lbl_cross_section",
        route="cuda",
        source="archnemesis_tpu_torch/csrc/lbl_cross_section.cu",
        replaces="archnemesis_tpu/ops/lbl_pallas.py:228",
        launches=(lbl_launches + table_launches + ingest_launches
                  + geom_lbl_launches),
        max_abs_err=lbl_record["max_abs_err"],
        ms=lbl_record["ms"],
        plain_ms=lbl_record["plain_ms"],
        bound_ms=lbl_record["bound_ms"],
        bound_by=lbl_record["bound_by"],
        library_ms=None,
    ), dict(
        name="lbl_cross_section_packed",
        route="cuda",
        source="archnemesis_tpu_torch/csrc/lbl_cross_section.cu",
        replaces="archnemesis_tpu/ops/lbl_pallas.py:312",
        **packed_record,
    )]
    kernels += [dict(
        name=f"overlap_variants_{mode}",
        route="cuda",
        source="archnemesis_tpu_torch/csrc/overlap_variants.cu",
        replaces="tools/bench_overlap_variants.py:131",
        **rec,
    ) for mode, rec in variant_records.items()]
    kernels += [dict(
        name=name,
        route="cuda",
        source="archnemesis_tpu_torch/csrc/tangent_ops.cu",
        replaces=None,
        **rec,
    ) for name, rec in tangent_records.items()]
    kernels.append(dict(
        name="fma_peak",
        route="cuda",
        source="archnemesis_tpu_torch/csrc/fma_peak.cu",
        replaces="tools/bench_vpu_peak.py:39",
        **fma_record,
    ))
    _print(f"total {time.perf_counter() - t0:.1f} s")
    _print(card)
    _print(json.dumps({"kernels": kernels}))
    _print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
