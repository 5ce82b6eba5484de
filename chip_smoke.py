#!/usr/bin/env python3
"""Smoke run of russell_tpu_torch on one NVIDIA GPU.

Drives the port's paths and checks them. The main path is Radau5 on the
2-D Brusselator PDE: with default Params (genie AUTO), which routes it to
GRIDMF, whose pivot-block inverses run the CUDA kernel ``gj_inv``; and
through the SPLU solver, whose factorize rows run ``splu_pairs``,
``gather_rows`` and ``gj_inv``. The ODE surface beside it: the Fortran
oracles on the card, DoPri5/DoPri8 on the Brusselator, BwEuler through
GRIDMF and Radau5 through the DENSE route. The BSR path is the sparse products of
``russell_tpu_torch.sparse`` — ``bsr_from_coo`` → ``bsr_matvec`` /
``bsr_matmat`` and ``spgemm_plan`` → ``spgemm`` — whose CUDA kernels are
``bsr_spmv``, ``bsr_spmm`` and ``spgemm_blocks``, in float64 and
complex128. The PDE and continuation tools (``russell_tpu_torch.pde``,
``nonlin``) reach the card through ``LinSolver`` and ``factor``. The
``stat``, ``tensor``, ``utils`` and CLI layer runs no hand kernel of its
own; ``bin.brusselator_pde`` at its defaults is the main path (AUTO →
GRIDMF → ``gj_inv``) through a user's entry point.

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel compiled from ``russell_tpu_torch/csrc``, one
   nvcc per source, all at once, with ptxas' register and spill lines;
3. warmup: factorize pairs back to back for WARM_S seconds, so that no
   timing below is the card's first work;
4. kernels: each SPLU kernel against its plain PyTorch version on the
   card, at the shapes of four rows of the npoint-129 plan (the most
   pairs, the most live lanes, the longest lane, the median len), with
   its device time (``time_ms``, calls back to back, L2 warm; and
   ``cold_ms``, L2 flushed before each call) beside its bound on the
   live-lanes contract and on the earlier all-TL-lanes one, the plain
   version's time and the library call's; then the W-1024 and W-4096
   timings in both orders, one call at a time (``call_ms``) and back to
   back;
5. the van der Pol oracle: all nine radau5.f counters, exactly;
6. the npoint-16 Brusselator: the reference package's counters, exactly,
   through SPLU (``brusselator_16``) and through GRIDMF (``gridmf_16``);
7. the SPLU main path: npoint 129, tolerances 1e-4, t in [0, 1], cold and
   warm, with each kernel's launch count from that run and its counters
   held to 237/21/27/70/27/25/1;
8. layers: one SPLU factorize pair, one solve pair and the diagonal-block
   inversion of one row, timed per call on the npoint-129 matrix;
9. gridmf_main_path: the same integration with default Params (AUTO →
   GRIDMF), cold and two warm runs (median and spread), gj_inv's
   launches counted from 0 in each run, counters held to the SPLU run's
   (or, where they differ, y to rtol 1e-6 of its y);
10. gridmf_layers: at npoint 129 and 513 one GRIDMF factorize pair and one
   solve pair: walls, device time and device launches under the profiler,
   GFLOP/s, peak memory, residuals max|A x - b| / max|b| <= 1e-10 of the
   real and the complex system; then the leaf sweep (16, 32, 64 cells);
11. gj_inv: the kernel against its plain version at every (w, m) of its
   base calls (the blocks ``splu._inv_block`` does not split, m <=
   ``splu.GJ_MAX_M``) in an npoint-129 SPLU pair and npoint-129 and 513
   GRIDMF pairs (513 also at leaf 16: up to 4,096 lanes), with zero
   pivots to clamp: Dinv bit-identical, min|pivot|, n_perturbed and sign
   exact, log|det| at rtol 1e-14; then per factorize pair (GRIDMF 129 and
   513, SPLU 129) the kernel's device time and launches and
   _inv_block's (the kernel, the recursion's GEMMs and cats), beside the
   bound of the pair's top-level pivot blocks and torch.linalg.inv_ex on
   them; and at the npoint-129 GRIDMF pair's base calls the kernel's
   L2-cold time, its plain version's and inv_ex's;
12. replay: one whole SPLU factorize pair under torch.profiler: each SPLU
   kernel's summed device time beside the bound of the same work, and
   the pair's device launches;
13. ode_samples: the radau5.f, dopri5.f, dop853.f and Euler oracles of
   tests/test_ode.py on the card with the default genie AUTO (DENSE for
   these systems): Radau5 on van der Pol, Robertson, Hairer-Wanner eq. 1
   and amplifier1t, DoPri5 on Hairer-Wanner and Arenstorf, DoPri8 on van
   der Pol, BwEuler and MdEuler on Hairer-Wanner; counters exact, y
   within the tolerances given there;
14. erk_path: DoPri5 and DoPri8 on the npoint-129 Brusselator (tolerances
   1e-4, t in [0, 1]) with stiffness detection recorded and dense stations
   every 0.1, on the card and on the CPU in this run: counters exact, y
   and stations at rtol 1e-10; then DoPri5 on the npoint-513 Brusselator
   on the card (y finite); each with its steps, wall, device launches per
   step and device busy share (profiled; at npoint 513 over the window t
   in [0, ERK_WINDOW_X1]) and where stiffness was detected;
15. bweuler_path: BwEuler on the npoint-129 Brusselator with default
   Params (AUTO → GRIDMF, so ``gj_inv`` runs) at equal steps of
   BWEULER_H: counters, wall, factorizations, ``gj_inv`` launches, y
   finite, and the last Newton solve's residual <= 1e-10;
16. dense_factor: Radau5 with default Params on the npoint-24 Brusselator
   (ndim 1,152 <= dense_threshold: AUTO → DENSE, grid hint or not) on the
   card and on the CPU (counters exact, y at rtol 1e-10); one factorize
   pair at the replay's shifts: residuals <= 1e-12, log|det|, min|pivot|
   and sign at rtol 1e-12 of the CPU's, the pair's and a solve pair's
   times per call;
17. bsr_kernels: each BSR kernel against its plain version on the card on
   the npoint-129 Brusselator Jacobian (8x128 blocks for SpMV and SpMM at
   m = 16, 16x16 blocks for A·A): the kernel's, the plain version's and
   the library call's time with the L2 flushed before each call (``ms``:
   at npoint 513 SpMV's whole working set fits the 50 MB L2, so only the
   cold time reads HBM as the bound assumes), the kernel's and library's
   back-to-back time beside it (``ms_warm_l2``), and the bound; SpMV and
   SpMM read the matrix's live-entry layout, whose build (``layout_s``,
   the first bsr_matvec), bytes and pad share are printed, and are held
   to the least bytes of the work (``bsr_work``: each nonzero once, the
   layout's slice offsets, x and y once) beside the bound over the stored
   8x128 blocks they were held to before (``stored_bound_ms``); SpGEMM
   reads its operands' live entries (a RowLayout built by the first
   spgemm on a matrix: ``first_call_s``, and ``updated_call_s`` after an
   in-place update of the blocks) and is held to the least bytes of its
   output form (``spgemm_work``: the live entries once, C written once)
   beside the bound over stored blocks (``stored_bound_ms``); two more
   launches of each kernel must give the same bits;
18. bsr_path: the BSR path through the public entry points on the
   npoint-513 Brusselator Jacobian J(y0) (n 526,338), with launch counts
   and peak device memory; then each product held against its kernel's
   plain version on the same inputs (every entry) and against scipy on
   the host, with the numbers of phase 17, nnz/s, GB/s and roofline share
   at these shapes. The kernels line reports the BSR kernels from this
   phase: measured numbers and the bound only (shares, the stored-block
   bounds, the layouts and first calls stay in the phase's lines);
19. bsr_complex: the three BSR products on complex128 matrices (J(y0) +
   0.3 i noise at npoint 129 and 513), each against its plain version and
   scipy, launched twice more for bit identity, timed as in phase 17; the
   kernels line carries the npoint-513 numbers under ``complex128``;
20. fused_path: ``solve(..., fused=True)`` and ``solve_batch``, the whole
   integration on the card as one captured CUDA graph per step attempt
   (conditional nodes for the skipped work, a done flag read every
   ``_device_loop.REPLAYS_PER_READ`` replays): the torch and CUDA
   versions; radau5.f's van der Pol and Robertson counters through DENSE,
   exactly; the bench.py configuration (default Params, AUTO -> GRIDMF,
   npoint 129) cold (warm-up, capture and instantiation shown apart) and
   FUSED_WARM_RUNS warm, with its nodes per step attempt (``gj_inv``'s
   too), replays, flag reads and device busy share (profiled device time
   over the warm median wall) beside phase 9's host-stepped walls,
   counters equal to phase 9's and y at atol 1e-12 of its y; the same
   run captured anew and replayed with one replay per flag read:
   bit-identical y and counters; SPLU at npoint 129 against phase 7
   (nodes of ``splu_pairs``, ``gather_rows``, ``gj_inv``); GRIDMF at
   npoint 513 against a host-stepped run in this phase (counters equal, y
   at atol 1e-10, walls, peak memory); DoPri5 at npoint 513 against
   phase 14's run (counters, y at rtol 1e-10; busy share over the window
   t in [0, ERK_WINDOW_X1]); DoPri8 at npoint 129 with dense stations
   every 0.1 against a host-stepped run (stations at atol 1e-10);
   ``solve_batch`` of FUSED_BATCH van der Pol lanes (DENSE) and of
   FUSED_BATCH DoPri5 Hairer-Wanner lanes, each lane held to a single
   fused solve (y at atol 1e-12, counters equal); then ``solve_batch``
   through the sparse genies, one batched numeric phase over one plan
   (``fused_batch_path``): AUTO -> GRIDMF and SPLU at npoint 129 with
   SPARSE_BATCH lanes spread from y0 (cold and warm walls, peak memory,
   against the summed walls of the lanes' single fused solves, each lane
   held to its single solve: counters equal, y at atol 1e-12; at least two
   step counts; each batched kernel's nodes per captured attempt equal to
   one lane's), GRIDMF at SPARSE_BATCH_WIDE lanes where it fits (walls
   and peak, or ``solve_batch``'s refusal before its capture), GENMF and
   BANDED by name at NPOINT_GENIES (one lane fused against the
   host-stepped run, counters equal and y bit for bit, then SPARSE_BATCH
   lanes held the same way), and each batched
   kernel at those lanes' shapes (``batch_kernel_checks``: held to its
   plain version and bit for bit to SPARSE_BATCH one-lane launches,
   ``gj_inv`` with a pivot threshold per matrix; timed against the
   one-lane launches beside the bound). Each kernel of the
   kernels line gains its nodes per captured attempt and its launches in
   the cold fused runs (``fused_path``), and the batched ones their
   numbers at the lanes (``batch``). ``--fused-batch`` runs the batches
   alone after the device and build phases.
21. lin_solver_path: ``LinSolver`` on the card at the reference's sparse
   benchmark sizes, each result held to SciPy's SuperLU on the host (x,
   log|det| and the determinant's sign or complex phase): GENMF on
   geometric_264k (``samples.irregular_geometric(263_743)``, seed 0,
   ``Genie.GENMF`` by name as the reference's benchmark runs it; AUTO's
   own route is recorded) with the host analysis, a cold and LS_WARM_RUNS
   warm factorizations (walls, device ms, launches, busy share, ``gj_inv``'s
   launches and ms, GFLOP/s over the plan's flops, peak memory), a warm
   solve, the relative error <= 1e-10 and x, log|det| within 1e-9, then
   complex values on the same plan; BANDED on laplacian_2d_317 (AUTO: k
   320, nb 315, cyclic reduction) and the sequential scan on it (x's equal
   at 1e-10), and a complex128 run; SPLU on laplacian_3d_50 (the
   reference's SPLU size, BENCHMARKS.md §2) with
   ``splu_pairs``, ``gather_rows`` and ``gj_inv`` counted from 0 over the
   run; every path's second factorize-and-solve bit-identical; and the
   ``solve_matrix_market`` CLI in a subprocess on its default device (the
   card) on a MatrixMarket file of ``irregular_geometric(30_000)`` with
   ``--genie genmf``. ``gj_inv``'s entry on the kernels line gains its
   GENMF-264k launches and ms per factorization, and the SPLU kernels'
   their launches per factorization on laplacian_3d_50. The SuperLU
   results are computed from the same seeded inputs (``ls_inputs``) in a
   spawned pool of ORACLE_WORKERS niced one-thread processes started at
   the smoke's start (``start_oracles``), so the phase only collects
   them; the pool's own wall and the phase's wait are printed.
22. pde_path: the PDE tools on the card. Poisson (``d2_problem_01``) on a
   PDE_NPOINT^2 grid (1,046,529 unknowns): the SPS system ``Fdm2d``
   builds, through one ``LinSolver`` with its grid hint (AUTO -> GRIDMF at
   leaf 64): host assembly, analysis, a cold and LS_WARM_RUNS warm
   factorizations (walls, device ms, launches, busy share, ``gj_inv``'s
   launches and ms, peak memory), one more with every ``gj_inv`` launch
   held to its plain version, a solve, the relative residual <= 1e-10
   and the error against the analytic phi <= PDE_ERR; then two
   ``solve_sps`` calls, bit-identical to each other and to that x. The
   same problem at PDE_SPLU_NPOINT^2 through ``Genie.SPLU`` with
   ``splu_pairs``, ``gather_rows`` and ``gj_inv`` counted from zero over a
   ``solve_sps``, x within 1e-10 of GRIDMF's, and a second ``solve_sps``
   with every launch held to its plain version (``held_to_plain``),
   bit-identical; ``Spc2d`` on Kopriva's problem at PDE_SPC_N^2 and
   ``SpcMap2d`` on the quarter ring through DENSE, against the analytic
   solutions. The kernels line gains each kernel's pde_path launches.
23. nonlin_path: the continuation solvers on the card. The 2-D Bratu
   problem by arclength at npoint 17 (russell_tpu's eight counters and
   step lambdas, written here as constants; the fold polished by
   extended-system Newton in torch on the card, within 1e-5 of
   6.80217410) and at BRATU_BIG with the default Config (ndim 65,025;
   AUTO's route, steps, factorizations, walls, the busy share of the
   solve over its first steps, the sample and the Solver built outside
   that window; lambda rises to its largest recorded value and falls
   while u_mid reaches 6; from the step at that value the fold polished
   by extended-system Newton through ``factor`` on the card, within
   BRATU_BIG_FOLD_TOL of Bolstad & Keller's value less the h^2 and h^4
   terms fitted to russell_tpu's folds at npoint 17 and 33, and above
   every recorded lambda; a second run with equal counters and bit-equal
   u); natural
   continuation on the 1-D Bratu and the B-spline problems with
   russell_tpu's counters. No hand kernel is on this path (DENSE and
   BANDED run cuSOLVER and cuBLAS).
24. lab_path: ``core``, ``math``, ``dense`` and ``algo`` at the sizes their
   users run, each result held to an oracle on the host. Dense f64 at
   LAB_N (``mat_mat_mul``, ``mat_cholesky``, ``solve_lin_sys``,
   ``mat_inverse`` with its det against numpy's slogdet,
   ``mat_eigen_sym``), ``mat_eigen_herm`` in complex128, ``mat_svd`` and
   ``mat_pseudo_inverse`` at LAB_N_HERM, ``mat_eigen`` batched and
   ``mat_gen_eigen`` at LAB_N_EIG: each held by its invariant against a
   seeded vector (residuals relative to the operands' norms <= 1e-12),
   with the first call's wall and device ms (set-up), the median of
   LAB_REPS calls after it and GFLOP/s where the flops are defined. Then
   ``jacobi_eig`` (``csrc/jacobi_eig.cu``) bit for bit against its plain
   version run on the CPU at JACOBI_PLAIN_N (the largest on each of the
   three routes: one CTA, a cluster of 16 CTAs and of 8, the cluster on
   global scratch), the plain version on the card once, and
   ``mat_eigen_sym_jacobi`` at JACOBI_N (its launches counted from 0 over
   those calls, each held bit for bit to the plain version run on the
   card) against ``torch.linalg.eigh`` (eigenvalues, |A V - V w| and
   |V^T V - I|): route and CTAs, time, the plain version's time, bound,
   ns a round, and the rounds and barriers the kernel's code runs.
   Then every elementwise public function of ``math`` on LAB_POINTS seeded
   points with the edge values first (poles, 0, +-1, negative arguments,
   the Bessel branch limits 8, 17, 26): every LAB_ORACLE_STRIDE-th point
   against ``scipy.special`` at tests/test_math.py's tolerances (``beta``
   and ``ln_beta`` at max(a, b) >= 8 at the reference's deviation from
   scipy there), the first LAB_CPU_POINTS against the port's CPU run
   (LAB_CPU_TOL where scipy is held more loosely); points/s and launches
   a call of ``bessel_jn(50)``, ``bessel_in(50)`` and ``elliptic_pi``.
   Then ``NewtonSolver`` at NEWTON_N (counters and u against the CPU run;
   u against a numpy Newton oracle), ``InterpChebyshev`` adapted then
   evaluated on LAB_POINTS points against its CPU evaluation, and
   ``RootFinder``, ``MinSolver`` and ``Quadrature`` (host work) with the
   reference's counters. The kernels line gains ``jacobi_eig``.
25. stat_tensor_path: ``stat``, ``tensor``, the ``bin`` CLIs and ``utils``
   on the card. Each of the five distributions (parameters with a fourth
   moment) draws ST_DRAWS f64 values from a seeded ``torch.Generator`` on
   the card: the same seed again gives the same bits; the sample mean and
   variance within ST_SE standard errors of ``mean()`` and ``variance()``;
   the KS statistic of the first ST_KS_N draws against its own ``cdf``
   under ST_KS_C / sqrt(n); ``pdf`` and ``cdf`` on ST_POINTS points over
   the quantiles [ST_PDF_Q, 1 - ST_PDF_Q] against ``scipy.stats`` at rtol
   ST_PDF_RTOL; draws/s, points/s and launches a call; then the draws
   copied to the host, ``Statistics`` on all of them and ``quartiles``,
   ``outliers`` and an ST_BINS-bin ``Histogram`` on the first ST_HOST_N,
   held to numpy. TENSOR_N seeded symmetric tensors (about 4 M Gauss
   points of a 500 k-hexahedra mesh) through ``torch.func.vmap``:
   ``LinElasticity.calc_stress``, the invariants, ``deriv1_invariant_lode``,
   ``deriv2_invariant_jj3``, ``deriv_inverse_tensor``, ``t4_ddot_t4`` of
   the last two and ``Spectral2(two_dim=True)`` on the Mandel-4 slice
   (points/s, launches, peak memory), and the 3-D ``Spectral2``, which
   reads the device, one call at a time on SPECTRAL_3D_N points; each
   held on TENSOR_SUBSET seeded points to the port's per-point CPU calls
   (run in TENSOR_CPU_WORKERS processes meanwhile) at TENSOR_RTOL
   (``tensor_held``). ``bin.brusselator_pde`` at its defaults (its
   counters equal to phase 20's fused GRIDMF-129 run's, ``gj_inv``
   launched), ``bin.amplifier1t`` on the card and on the CPU (counters
   equal), ``bin.mem_check`` on the card (exit 0, no growth of the bytes
   the live tensors requested from the first factorize-and-solve to the
   second), a
   ``CheckpointManager`` snapshot every CHECKPOINT_EVERY accepted steps
   of van der Pol (the last reloads to its step's x, y and h bit for
   bit), and ``utils.trace`` around a warm GRIDMF-129 factorize pair,
   whose trace file must hold ``gj_inv``'s kernel. The kernels line's
   ``gj_inv`` gains the CLI's launches.
26. parallel_path: ``russell_tpu_torch.parallel`` on the card. (a) A world
   of one rank under NCCL in this process (a file store in a temporary
   directory, left at the end): ``dist_gridmf_*`` on gamma M - J of the
   npoint-513 Brusselator, ``dist_splu_factorize`` on the npoint-129 SPLU
   plan, ``dist_genmf_*`` on geometric_264k, ``shard_banded_*`` on
   laplacian_2d_317 (BCR), ``dist_mat_vec_mul`` on the npoint-513
   Jacobian and ``batch_factor_solve`` of PAR_BATCH shifts gamma_i M - J
   at npoint 129 (AUTO's GRIDMF plan), each held bit for bit to the same
   call on one device (factors depth by depth, x, the statistics), with
   both calls' walls, device ms, device launches and the SPLU kernels' and
   ``gj_inv``'s launches. (b) PAR_RANKS ranks spawned on the one card
   under gloo (NCCL refuses two ranks on one card), each running
   ``dist_gridmf`` at npoint 129, ``dist_splu`` at 65, ``dist_genmf`` on
   laplacian_3d_50, BCR on laplacian_2d_317, the SpMV at 513 and the batch
   at 65, cold then warm, and writing its results: held to this process's
   single-device results (factors within PAR_FAC_TOL (1 + max), absolute
   residual under PAR_RES_TOL, log|det| within PAR_LOGDET_TOL), each
   kernel of a check launched on every rank; a rank that raises or runs
   past PAR_RANK_TIMEOUT_S fails the phase. The kernels line's
   ``splu_pairs``, ``gather_rows`` and ``gj_inv`` gain the launches.
27. ooc_path: GRIDMF out of core through ``LinSolver(Genie.AUTO)`` with
   the grid hint (N, N, N) on ``samples.laplacian_3d(N)``. The host's
   MemTotal and MemAvailable; the transfers' yardstick, a 1 GiB ``copy_``
   each way from torch's pinned memory and from an out-of-core store
   (GB/s). (a) N = OOC_NPOINT_IN_CORE, in core by the default budget
   (13.2 GiB of f64 factors under 15): cold and warm factorize walls, the
   solve's wall, peak device memory, relative error; then out of core
   (``factor.GRIDMF_BUDGET_GB`` set under its store here): x within
   OOC_X_TOL of max|x| of the in-core x, log|det|, min|pivot| and
   n_perturbed equal, peak device memory below the in-core run's (one
   factorization: each maps and pins its host stores anew). (b) N =
   OOC_NPOINT (49.1 GiB: out of core by the default budget): one
   factorization under the profiler with the first ``gj_inv`` launch at
   each (w, m) held to its plain version (``held_once_a_shape``): wall,
   launches, peak device memory below the store's bytes, host bytes pinned
   against the store's, GFLOP/s, the copies' device time and the busy
   share; a solve (wall, peak), relative error <= OOC_RES_TOL, log|det|
   within OOC_LOGDET_RTOL of the analytic sum, one sweep pair under the
   profiler (H2D GB/s), and the time to free the host stores. The kernels
   line's ``gj_inv`` gains the path's launches and checks. ``--ooc`` runs it
   alone (with the kernels line and the last line).
28. examples_path: every ``examples_torch/ex_*.py`` (the counterpart of
   each reference example) on the card in this process, through
   ``runpy`` with ``--device cuda``: each example's wall and standard
   output, and the package's settings before and after it, which must be
   equal (``examples_torch/_run.py``); an example that raises fails the
   phase. The same examples run on the CPU in a subprocess started at the
   smoke's start (niced, one intra-op thread), and each example's card
   output is held to its CPU output by the comparison of the CPU parity
   test (``examples_torch/_stdout.py``). ``gj_inv``, ``splu_pairs``,
   ``gather_rows`` and ``jacobi_eig`` are counted from 0 over the phase,
   each count above 0; in EXAMPLES_HELD the first launch of each at each
   shape is held to its plain version (``held_once_a_shape``; a fused
   solve's first launches are its warm-up's, outside the capture).
   Each of the four kernels' entries on the kernels line gains its
   ``examples_path`` launches and checks. ``--examples`` runs it alone
   (with the kernels line and the last line);
29. mixed_path: ``LinSolParams(mixed_precision=True)`` (f32/complex64
   factors, the adaptive refinement at f64) with the f32 builds' launch
   counts set to 0 at its start: the kappa-1e9 n-60 dense system, which
   must escalate to f64 factors once; GRIDMF laplacian_2d 1000 (10^6
   unknowns, the FCG tier) against the same plan at f64 (factor bytes at
   most 0.55 of f64's, peak, walls, the tiers' rounds, x within 1e-10);
   SPLU laplacian_3d_50 with every f32 ``splu_pairs``, ``gather_rows``
   and ``gj_inv`` launch of a factorization held to its plain version;
   GENMF on a complex irregular_geometric(20,000) (complex64 factors,
   complex128 x); GRIDMF laplacian_3d_40 out of core (host stores half
   the f64 run's). The kernels line gains the three f32 builds' entries,
   timed at the phase's shapes. ``--mixed-path`` runs it alone (with the
   kernels line and the last line).

Every phase raises on failure, so the exit code is non-zero. The line
before the last is the kernels' JSON; the last is
``{"ok": true, "device": {...}}``. Run from the repository root:

    python3 chip_smoke.py

To compare two trees on one card, unpack the other tree (``git
archive``) into an ignored directory and run ``python3 chip_smoke.py --ab
DIR [ROUNDS]``: the replay of phase 12 (with its device launches per
factorize pair), one GRIDMF factorize pair at npoint 129 and 513 (device
launches, device ms, profiled and median walls), the default path's cold
and warm walls at npoint 129 (median of three, with the spread) and the
npoint-513 ``bsr_matvec`` / ``bsr_matmat`` / ``spgemm`` times (back to
back, and the first call on a new matrix and after an in-place update of
its blocks, which builds the live layout) with DIR's package and with
this tree's, each in its own process, in turns P C C P, ROUNDS times,
then the medians, the ratios and the number of calls that pays for one
layout build. ``--replay [--tree DIR]`` is one such process.
``--lin-solver-path`` runs only phase 21 (after the device and build
phases), ``--pde-nonlin`` only phases 22 and 23, ``--lab`` only phase 24
(with its kernels line and the last line), ``--stat-tensor`` only phase
25 (with the last line; the fused GRIDMF-129 counters from a run of its
own), ``--parallel`` only phase 26 (with the last line), ``--ooc`` only
phase 27, ``--examples`` only phase 28, ``--mixed-path`` only phase 29.
``--chunk-sweep`` times
``splu_pairs`` over every row of the npoint-129 plan for each chunk size
K of CHUNK_SWEEP, which is how ``splu.CHUNK_PAIRS`` was chosen;
``--strip-sweep`` times ``spgemm`` at npoint 513 for each strip budget of
STRIP_SWEEP, which is how ``kernels.SPGEMM_STRIP_BYTES`` was chosen;
``--base-sweep`` runs the factorize pairs that reach ``gj_inv`` for each
recursion base of BASE_SWEEP, which is how ``splu.GJ_MAX_M`` was chosen.
``--banded-ab DIR [ROUNDS]`` compares BANDED's walls (laplacian_2d_317
through cyclic reduction and the scan, Bratu-2-D 257) in DIR's package
and this tree's, P C C P, with torch's batched LU and solves at BCR's
shapes (``--banded [--tree DIR]`` is one such process);
``--fused-memory GENIE:NPOINT:LANES[:warmup] ...`` reads the allocator
through a fused Radau5 loop's set-up, warm-up, capture and first run.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if __name__ == "__main__" and "--tree" in sys.argv:
    # the A/B replay (--ab): this script run against another tree's package
    sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--tree") + 1]))

import russell_tpu_torch  # noqa: E402  (fails at once outside the repo)

SEED = 129
NPOINT = 129
NPOINT_BSR = 513     # the reference's matched scale (bench.py:141-146)
ALPHA = 2e-3
REPS = 20
SPMM_M = 16
# the least time the card could take (NVIDIA H100 SXM data sheet): HBM3 at
# 3.35 TB/s, and 67 TFLOP/s FP64 on the tensor cores (34 TFLOP/s FP64 FMA
# outside them; the larger peak gives the smaller, safe bound)
HBM_BYTES_PER_S = 3.35e12
F64_FLOPS_PER_S = 67e12
# kernel against its plain version: the summation order differs
RTOL = 1e-12
F32_ULP = 2.0 ** -23      # an f32 build against its plain version
GJ_LOGDET_RTOL = {torch.float64: 1e-14, torch.float32: 2e-6}
# the replay's matrices: Radau5's real and complex shifts (radau5.f's
# GAMMA, ALPHA + i BETA) at h = 0.1, minus the Brusselator Jacobian at y0
H_REPLAY = 0.1
GAMMA = 3.6378342527444957 / H_REPLAY
ALPHA_BETA = complex(2.6810828736277521, 3.0504301992474105) / H_REPLAY
WARM_S = 1.0          # the card is kept busy this long before timing
CHUNK_SWEEP = (2, 4, 8, 16)
# spgemm_blocks' strip budgets in bytes (--strip-sweep)
STRIP_SWEEP = (16 << 10, 32 << 10, 64 << 10, 96 << 10)
# recursion bases of the pivot inverse (--base-sweep: splu.GJ_MAX_M)
BASE_SWEEP = (32, 64, 128, 136, 144)
# read before each call that cold_ms times: over twice the H100's 50 MB L2
L2_FLUSH_BYTES = 128 << 20


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    flops over the f64 peak."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_flops = 1e3 * flops / F64_FLOPS_PER_S
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def reset_launch_counts():
    from russell_tpu_torch.sparse import kernels, splu
    splu.reset_launch_counts()
    kernels.reset_launch_counts()
    lanes = sys.modules.get("russell_tpu_torch.ode._lanes")
    if lanes is not None:
        lanes.lane_pow.launches = 0
    dense = sys.modules.get("russell_tpu_torch.dense.matrix_ops")
    if dense is not None:
        dense.reset_launch_counts()


def gj_inv_launches():
    """The gj_inv wrapper's launch count (0 in a tree without it, which
    --ab replays too)."""
    from russell_tpu_torch.sparse import splu
    return getattr(getattr(splu, "_gj_inv", None), "launches", 0)


def assert_close(name, got, want):
    """Hold ``got`` to ``want`` at rtol 1e-12, atol 1e-12 x max|want|;
    returns (max |got - want|, max |want|). f32 values (the f32 builds,
    which sum in f64 and round once, in another order than their plain
    versions) at rtol F32_ULP, one f32 ulp."""
    got = torch.as_tensor(got)
    want = torch.as_tensor(want, device=got.device)
    scale = float(want.abs().max())
    rtol = F32_ULP if got.dtype == torch.float32 else RTOL
    torch.testing.assert_close(got, want, rtol=rtol, atol=RTOL * scale,
                               msg=lambda m: f"{name}: {m}")
    return float((got - want).abs().max()), scale


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, reps=REPS, warmup=3):
    """Device time of one call of ``fn`` in ms: ``reps`` calls back to back
    between two CUDA events, queued behind a sleep kernel long enough for
    the host to queue them all, so the device runs them without waiting on
    the host (the host's launch cost is not in the figure)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    # cycles at up to 2 GHz: a slower clock only lengthens the sleep
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 1e-3)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps=REPS, warmup=3):
    """Median device time of one call of ``fn`` in ms with a cold L2: a
    buffer of L2_FLUSH_BYTES is read before each call and two CUDA events
    bracket the call alone, all queued behind a sleep kernel as in
    ``time_ms``. The call's inputs then come from HBM, as the bounds
    assume."""
    flush = torch.ones(L2_FLUSH_BYTES // 8, dtype=torch.float64,
                       device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        flush.sum()
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 1e-3)))
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def call_ms(fn, reps=REPS, warmup=3):
    """Median time of ``fn`` in ms with CUDA events around each call, one
    call at a time: the host's launch cost is included when it exceeds
    the kernel's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_device_ms(fn):
    """Run ``fn`` once under torch.profiler (CUDA activity) and return
    ({kernel name: summed device ms} of every kernel it ran, the host wall
    of the run in s, the number of device events it ran: kernels, copies
    and fills, each counted whatever its duration: an event recorded with
    0 device time is a launch too). The sums are read from the raw device
    events: ``key_averages()`` gives the same sums but builds an event tree
    first, which made it the costliest host step of a whole smoke."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {}
    launches = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        launches += 1
        ms = (ev.end_ns() - ev.start_ns()) / 1e6
        if ms > 0:
            out[ev.name()] = out.get(ev.name(), 0.0) + ms
    return out, wall, launches


def summed(ms_by_name, pattern):
    return sum(v for k, v in ms_by_name.items() if pattern in k)


def counters(st):
    return {k: getattr(st, k) for k in (
        "n_function", "n_jacobian", "n_factor", "n_lin_sol", "n_steps",
        "n_accepted", "n_rejected", "n_iterations", "n_iterations_max")}


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false: "
                         "this smoke run needs a CUDA device")
    smi = nvidia_smi()
    print(smi, flush=True)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build():
    from russell_tpu_torch.sparse import _cuda
    t0 = time.perf_counter()
    _cuda.build_all()
    wall = time.perf_counter() - t0
    for name in getattr(_cuda, "LIBRARIES", _cuda.KERNELS):
        _cuda.library(name)
        info = _cuda.build_info(name)
        say("build", kernel=name, all_wall_s=wall,
            nvcc_seconds=info.get("seconds"),
            ptxas=[ln.strip() for ln in info.get("log", "").splitlines()
                   if "registers" in ln or "spill" in ln or "smem" in ln])


def brusselator_plan(npoint):
    """The SolvePlan Radau5 builds for the Brusselator at ``npoint``."""
    from russell_tpu_torch.ode import samples
    from russell_tpu_torch.sparse import factor
    from russell_tpu_torch.sparse.enums import Genie
    system = samples.brusselator_pde(ALPHA, npoint)[0]
    ii, jj = system.jac_structure
    ndim = system.ndim
    rows = np.concatenate([ii, np.arange(ndim)])
    cols = np.concatenate([jj, np.arange(ndim)])
    return factor.analyze(ndim, rows, cols, genie=Genie.SPLU)


def replay_setup(npoint=NPOINT):
    """The plan and the real/complex values of one Radau5 factorize pair
    on the npoint Brusselator, through public functions only (the parent
    tree has them too, so --ab replays it with either package)."""
    from russell_tpu_torch.ode import samples
    from russell_tpu_torch.sparse import factor
    from russell_tpu_torch.sparse.enums import Genie
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, npoint)
    ii, jj = system.jac_structure
    n = system.ndim
    plan = factor.analyze(n, np.concatenate([ii, np.arange(n)]),
                          np.concatenate([jj, np.arange(n)]),
                          genie=Genie.SPLU)
    jv = system.jacobian(t0, torch.as_tensor(y0), None).numpy()
    dev = torch.device("cuda")
    vr = torch.as_tensor(np.concatenate([-jv, np.full(n, GAMMA)]),
                         device=dev)
    vc = torch.as_tensor(np.concatenate([-jv + 0j, np.full(n, ALPHA_BETA)]),
                         device=dev)
    return plan, vr, vc


def warm_up(setup):
    """Factorize pairs back to back for WARM_S seconds, at least one (it
    builds the kernels at first use); returns (pairs, wall s)."""
    from russell_tpu_torch.sparse import factor
    t0 = time.perf_counter()
    n = 0
    while n == 0 or time.perf_counter() - t0 < WARM_S:
        factor.numeric_factorize_pair(*setup)
        torch.cuda.synchronize()
        n += 1
    return n, time.perf_counter() - t0


def replay(setup):
    """After ``warm_up``, one factorize pair under torch.profiler: each SPLU
    kernel's summed device time per factorize pair (gj_inv's 0 in a tree
    without it), all device time and device launches, and the host wall
    of the profiled pair."""
    from russell_tpu_torch.sparse import factor
    warm, warm_wall = warm_up(setup)
    ms, wall, launches = kernel_device_ms(
        lambda: factor.numeric_factorize_pair(*setup))
    return {"splu_pairs_ms": summed(ms, "splu_pairs"),
            "gather_rows_ms": summed(ms, "gather_rows"),
            "gj_inv_ms": summed(ms, "gj_inv"),
            "device_busy_ms": sum(ms.values()),
            "device_launches": launches,
            "profiled_wall_s": wall, "warm_pairs": warm,
            "warm_wall_s": warm_wall,
            "package": os.path.dirname(russell_tpu_torch.__file__)}


def pairs_bounds(pk, r, be, ln, npair, n_chunks):
    """splu_pairs' bound on row r at width be, on the live-lanes contract
    and on the earlier one that wrote all TL lanes: each distinct tile read
    once, the lanes written once, the index arrays the kernel reads;
    2 be^3 flops per pair. Returns ((ms, by), (ms, by))."""
    TL = pk["TL"]
    tiles = np.unique(np.concatenate([pk["pair_l"][r, :npair],
                                      pk["pair_u"][r, :npair]])).size
    flops = 2 * npair * be ** 3
    return (bound(8 * be * be * (tiles + ln) + 4 * (2 * npair + 2 * ln)
                  + 16 * n_chunks, flops),
            bound(8 * be * be * (tiles + TL) + 4 * (2 * npair + TL + 1),
                  flops))


def named_rows(sp, dp):
    """phase_kernels' rows: the most pairs, the most live lanes (len), the
    longest lane (pairs in series in the earlier design), the median len."""
    from russell_tpu_torch.sparse import splu
    TL = sp.packed["TL"]
    seg_ptr = splu._seg_ptr(sp.packed["pair_seg"], TL)
    lens = np.asarray([r[1] for r in dp["rows"]])
    npair = np.asarray([r[3] for r in dp["rows"]])
    longest = np.asarray([np.diff(seg_ptr[r, :lens[r] + 1]).max()
                          for r in range(len(lens))])
    return ({"argmax_pairs": int(npair.argmax()),
             "argmax_len": int(lens.argmax()),
             "longest_lane": int(longest.argmax()),
             "median_len": int(np.argsort(lens, kind="stable")[
                 len(lens) // 2])}, longest)


def phase_warmup():
    """Keep the card busy with factorize pairs for WARM_S before anything
    is timed (the clocks settle; first-use set-up is done)."""
    n, wall = warm_up(replay_setup())
    say("warmup", factorize_pairs=n, wall_s=wall)


def phase_kernels(plan):
    """Each SPLU kernel against its plain version at the shapes of four
    rows of the npoint-129 plan, with its device time (L2 warm and cold)
    beside its bounds, the plain version's and (gather_rows) the library
    call's (warm and cold); and the
    W-1024 and W-4096 timings in both orders by both timing methods.
    Returns the results."""
    from russell_tpu_torch.sparse import splu
    sp = plan.splu_plan
    pk = sp.packed
    dev = torch.device("cuda")
    dp = splu._device_plan(sp, dev)
    TL = pk["TL"]
    named, longest = named_rows(sp, dp)
    say("kernel_rows", K=splu.CHUNK_PAIRS, rows={
        name: {"row": r, "len": dp["rows"][r][1], "pairs": dp["rows"][r][3],
               "longest_lane": int(longest[r]), "chunks": dp["rows"][r][5],
               "multi_chunks": dp["rows"][r][6]}
        for name, r in named.items()})
    rng = np.random.default_rng(SEED)
    n_store = sp.nblk + TL + 1
    results = {}
    blocks_w = {}

    def row_args(blocks, r, be):
        n, ln = dp["rows"][r][3], dp["rows"][r][1]
        return (blocks, dp["pair_l"][r, :n], dp["pair_u"][r, :n],
                dp["pair_seg"][r, :n], dp["work"][r], ln, be)

    for be in (sp.b, 2 * sp.b):
        blocks = torch.as_tensor(
            rng.standard_normal((n_store, be * be)), device=dev)
        blocks_w[be] = blocks
        for name, r in named.items():
            args = row_args(blocks, r, be)
            ln, npair = args[5], args[1].numel()
            got = splu.splu_pairs(*args)
            again = splu.splu_pairs(*args)
            want = splu._splu_pairs_plain(*args[:4], ln, be)
            err, scale = assert_close(f"splu_pairs {name} be {be}", got, want)
            if not torch.equal(got, again):
                raise AssertionError(f"splu_pairs {name} be {be}: two "
                                     "launches differ")
            live, full = pairs_bounds(pk, r, be, ln, npair, dp["rows"][r][5])
            ms = time_ms(lambda: splu.splu_pairs(*args))
            cold = cold_ms(lambda: splu.splu_pairs(*args))
            plain_ms = time_ms(lambda: splu._splu_pairs_plain(*args[:4], ln,
                                                              be))
            say("kernel", name="splu_pairs", row_name=name, row=r, be=be,
                len=ln, pairs=npair, max_abs_err=err, scale=scale, rtol=RTOL,
                bit_identical=True, ms=ms, ms_cold_l2=cold, plain_ms=plain_ms,
                library_ms=None, bound_ms=live[0], bound_by=live[1],
                share=live[0] / ms, share_cold_l2=live[0] / cold,
                bound_tl_ms=full[0], bound_tl_by=full[1],
                share_tl=full[0] / ms)
            results[("splu_pairs", name, be)] = (
                err, ms, plain_ms, None, live[0], live[1], cold)

            idx = dp["dinv"][r, :ln]
            if not torch.equal(splu.gather_rows(blocks, idx),
                               splu._gather_rows_plain(blocks, idx)):
                raise AssertionError(f"gather_rows differs from blocks[idx] "
                                     f"at W={be * be}")
            ms = time_ms(lambda: splu.gather_rows(blocks, idx))
            cold = cold_ms(lambda: splu.gather_rows(blocks, idx))
            plain_ms = time_ms(lambda: splu._gather_rows_plain(blocks, idx))
            library_ms = time_ms(lambda: torch.index_select(blocks, 0, idx))
            library_cold = cold_ms(lambda: torch.index_select(blocks, 0, idx))
            b_ms, b_by = bound(8 * be * be * (torch.unique(idx).numel() + ln)
                               + 4 * ln, 0)
            say("kernel", name="gather_rows", row_name=name, row=r,
                rows=ln, W=be * be, max_abs_err=0.0, ms=ms, ms_cold_l2=cold,
                plain_ms=plain_ms, library_ms=library_ms,
                library_ms_cold_l2=library_cold, bound_ms=b_ms,
                bound_by=b_by, share=b_ms / ms, share_cold_l2=b_ms / cold,
                distinct_sources=int(torch.unique(idx).numel()))
            results[("gather_rows", name, be)] = (
                0.0, ms, plain_ms, library_ms, b_ms, b_by, cold)

    # the W-1024 / W-4096 timings in both orders, one call at a time (host
    # launch cost included) and back to back (device time)
    r = named["argmax_len"]
    for order in ((sp.b, 2 * sp.b), (2 * sp.b, sp.b)):
        rec = {}
        for be in order:
            blocks = blocks_w[be]
            idx = dp["dinv"][r, :dp["rows"][r][1]]
            args = row_args(blocks, r, be)
            fns = {"gather_rows": lambda: splu.gather_rows(blocks, idx),
                   "index_select": lambda: torch.index_select(blocks, 0,
                                                              idx),
                   "splu_pairs": lambda: splu.splu_pairs(*args)}
            rec[f"W{be * be}"] = {k: {"call_ms": call_ms(f),
                                      "ms": time_ms(f)}
                                  for k, f in fns.items()}
        say("order", row=r, widths=[be * be for be in order], **rec)
    del blocks_w, blocks
    torch.cuda.empty_cache()
    return results


def chunk_sweep(plan):
    """splu_pairs' device time over every row of the plan, b and 2b, under
    torch.profiler, for each chunk size K of CHUNK_SWEEP."""
    from russell_tpu_torch.sparse import splu
    sp = plan.splu_plan
    pk = sp.packed
    dev = torch.device("cuda")
    dp = splu._device_plan(sp, dev)
    rng = np.random.default_rng(SEED)
    blocks_w = {be: torch.as_tensor(rng.standard_normal(
        (sp.nblk + pk["TL"] + 1, be * be)), device=dev)
        for be in (sp.b, 2 * sp.b)}
    seg_ptr = splu._seg_ptr(pk["pair_seg"], pk["TL"])
    for K in CHUNK_SWEEP:
        works = []
        for r, row in enumerate(dp["rows"]):
            c, off, n_multi = splu._pair_chunks(seg_ptr[r], row[1], K)
            works.append(splu.PairWork(torch.as_tensor(c, device=dev),
                                       torch.as_tensor(off, device=dev),
                                       n_multi))
        rec = {}
        for be, blocks in blocks_w.items():
            def every_row():
                for r, row in enumerate(dp["rows"]):
                    n = row[3]
                    splu.splu_pairs(blocks, dp["pair_l"][r, :n],
                                    dp["pair_u"][r, :n],
                                    dp["pair_seg"][r, :n], works[r], row[1],
                                    be)
            every_row()
            rec[f"be{be}_ms"] = summed(kernel_device_ms(every_row)[0],
                                       "splu_pairs")
        say("chunk_sweep", K=K, chunks=sum(len(w.chunk) for w in works),
            **rec)


def phase_replay(plan):
    """phase_kernels' profiled part: one whole factorize pair (every row,
    both widths) under the profiler, beside the bound of the same work on
    both contracts. It runs after the main path, so that the profiler's
    tracing cannot reach the main path's wall."""
    from russell_tpu_torch.sparse import splu
    sp = plan.splu_plan
    pk = sp.packed
    dp = splu._device_plan(sp, torch.device("cuda"))
    rep = replay(replay_setup())
    bounds = {"live": 0.0, "tl": 0.0}
    for r, row in enumerate(dp["rows"]):
        for be in (sp.b, 2 * sp.b):
            live, full = pairs_bounds(pk, r, be, row[1], row[3], row[5])
            bounds["live"] += live[0]
            bounds["tl"] += full[0]
    g_bound = sum(bound(8 * be * be * (np.unique(pk["dinv"][r, :row[1]]).size
                                       + row[1]) + 4 * row[1], 0)[0]
                  for r, row in enumerate(dp["rows"])
                  for be in (sp.b, 2 * sp.b))
    say("replay", npoint=NPOINT, **rep,
        splu_pairs_bound_ms=bounds["live"],
        splu_pairs_bound_tl_ms=bounds["tl"],
        splu_pairs_share=bounds["live"] / rep["splu_pairs_ms"],
        splu_pairs_share_tl=bounds["tl"] / rep["splu_pairs_ms"],
        gather_rows_bound_ms=g_bound,
        gather_rows_share=g_bound / rep["gather_rows_ms"])
    return rep


def solve_radau5(system, y0, x1, params, dev):
    from russell_tpu_torch.ode import OdeSolver
    sol = OdeSolver(params, system, dev)
    y = sol.solve(y0, 0.0, x1)
    torch.cuda.synchronize()
    return sol, y


def phase_van_der_pol():
    from russell_tpu_torch.ode import Method, Params, samples
    from russell_tpu_torch.sparse.enums import Genie
    system, x0, y0, x1, _ = samples.van_der_pol(1e-6, False)
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    params.newton.genie = Genie.SPLU
    t0 = time.perf_counter()
    sol, y = solve_radau5(system, y0, x1, params, "cuda")
    wall = time.perf_counter() - t0
    st = sol.stats()
    got = counters(st)
    want = {"n_function": 2249, "n_jacobian": 162, "n_factor": 253,
            "n_lin_sol": 668, "n_steps": 280, "n_accepted": 242,
            "n_rejected": 8, "n_iterations": 2, "n_iterations_max": 6}
    y = y.cpu().numpy()
    say("van_der_pol", wall_s=wall, counters=got, y=y.tolist(),
        h_accepted=st.h_accepted)
    if got != want:
        raise AssertionError(f"van der Pol counters {got} != radau5.f {want}")
    # tests/test_ode.py:57-68
    if (abs(y[0] - 1.706163410178079) >= 1e-12
            or abs(y[1] + 0.8927971289301175) >= 1e-11
            or abs(st.h_accepted - 0.1510987221365367) >= 1e-6):
        raise AssertionError("van der Pol y / h_accepted off the oracle")


def phase_brusselator_small():
    from russell_tpu_torch.ode import Method, Params, samples
    from russell_tpu_torch.sparse.enums import Genie
    system, _, y0, _ = samples.brusselator_pde(ALPHA, 16)
    params = Params(Method.RADAU5)
    params.newton.genie = Genie.SPLU
    t0 = time.perf_counter()
    sol, y = solve_radau5(system, y0, 1.0, params, "cuda")
    wall = time.perf_counter() - t0
    got = counters(sol.stats())
    say("brusselator_16", wall_s=wall, counters=got,
        y_min=float(y.min()), y_max=float(y.max()))
    # the reference package's Radau5 + SPLU run on the CPU (f64)
    want = {"n_accepted": 25, "n_rejected": 1, "n_factor": 26,
            "n_lin_sol": 68, "n_jacobian": 22}
    if {k: got[k] for k in want} != want or not bool(
            torch.isfinite(y).all()):
        raise AssertionError(f"npoint-16 Brusselator counters {got} != "
                             f"{want} (or y not finite)")


def phase_main_path(plan_rows):
    from russell_tpu_torch.ode import Method, OdeSolver, Params, samples
    from russell_tpu_torch.sparse import splu
    from russell_tpu_torch.sparse.enums import Genie
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT)
    params = Params(Method.RADAU5)
    params.set_tolerances(1e-4, 1e-4)
    params.newton.genie = Genie.SPLU
    dev = torch.device("cuda")
    runs = {}
    for run in ("cold", "warm"):
        if run == "warm":  # a fresh solver; its host analysis is untimed
            sol = OdeSolver(params, system, dev)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t_start = time.perf_counter()
        if run == "cold":  # the cold run includes the host analysis
            sol = OdeSolver(params, system, dev)
        y = sol.solve(y0, t0, 1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = {"splu_pairs": splu.splu_pairs.launches,
                    "gather_rows": splu.gather_rows.launches,
                    "gj_inv": splu._gj_inv.launches}
        st = sol.stats()
        got = counters(st)
        runs[run] = {"wall_s": wall, "counters": got, "launches": launches,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                     "nanos_factor_max": st.nanos_factor_max,
                     "nanos_lin_sol_max": st.nanos_lin_sol_max}
        say("main_path", run=run, npoint=NPOINT, ndim=system.ndim,
            rows=plan_rows, **runs[run],
            y_shape=list(y.shape), y_min=float(y.min()),
            y_max=float(y.max()))
        if tuple(y.shape) != (system.ndim,) or not bool(
                torch.isfinite(y).all()):
            raise AssertionError("main path: y is not finite of shape "
                                 f"({system.ndim},)")
        need = got["n_factor"] * plan_rows
        for name in ("splu_pairs", "gather_rows"):
            if launches[name] < need:
                raise AssertionError(f"main path: {name} launched "
                                     f"{launches[name]} times, fewer than "
                                     f"n_factor x rows = {need}")
        if launches["gj_inv"] <= 0:
            raise AssertionError("main path: gj_inv was not launched")
        # the counters of PR 1-5's runs of this path
        want = {"n_function": 237, "n_jacobian": 21, "n_factor": 27,
                "n_lin_sol": 70, "n_steps": 27, "n_accepted": 25,
                "n_rejected": 1}
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"main path counters {got} != {want}")
    return sol, y, runs


def phase_layers(sol, y):
    """Factorize pair, solve pair and one row's block inversion, timed on
    the npoint-129 matrix at the end state."""
    from russell_tpu_torch.sparse import factor, splu
    r5 = sol.actual
    h = sol.stats().h_accepted
    jv = r5._jac_fn(1.0, y, None)

    def fact():
        return r5._factorize(jv, h)

    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fr, fc = fact()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    factor_ms = call_ms(fact, reps=3, warmup=0)
    rng = np.random.default_rng(SEED)
    n = sol.ndim
    br = torch.as_tensor(rng.standard_normal(n), device=y.device)
    bc = torch.complex(br, torch.as_tensor(rng.standard_normal(n),
                                           device=y.device))
    solve_ms = call_ms(lambda: factor.factor_solve_pair(
        r5.plan, fr, fc, br, bc, refine_steps=0), reps=10)
    sp = r5.plan.splu_plan
    nd = max(r[2] for r in splu._device_plan(sp, y.device)["rows"])
    D = torch.as_tensor(rng.standard_normal((nd, 64, 64)), device=y.device)
    delta = torch.tensor(1e-14, dtype=torch.float64, device=y.device)
    inv32_ms = call_ms(lambda: splu._inv_block(D[:, :32, :32], delta))
    inv64_ms = call_ms(lambda: splu._inv_block(D, delta))
    say("layers", factorize_pair_wall_ms=[1e3 * w for w in walls],
        factorize_pair_device_ms=factor_ms, solve_pair_ms=solve_ms,
        inv_block_lanes=nd, inv_block_b32_ms=inv32_ms,
        inv_block_b64_ms=inv64_ms)


def inv_block_bases(m, w, out):
    """Append the (w, m) of each Gauss-Jordan base call that
    ``splu._inv_block`` makes on a (w, m, m) batch (its 2x2 Schur
    recursion down to m <= ``splu.GJ_MAX_M``)."""
    from russell_tpu_torch.sparse import splu
    if m <= splu.GJ_MAX_M:
        out.append((w, m))
        return
    h = m // 2
    inv_block_bases(h, w, out)
    inv_block_bases(m - h, w, out)


def gridmf_top_blocks(gplan):
    """{(w, m): calls} of ``splu._inv_block`` in one GRIDMF factorize pair:
    per depth the real plane's pivot blocks (e) and the complex one's K
    embedding (2e)."""
    return collections.Counter(
        blk for lv in gplan.levels
        for blk in ((lv.n_nodes, lv.e), (lv.n_nodes, 2 * lv.e)))


def splu_top_blocks(plan):
    """{(w, m): calls} of ``splu._inv_block`` in one SPLU factorize pair:
    per row with diagonal lanes, the real state's (nd, b) and the K
    state's (nd, 2b)."""
    from russell_tpu_torch.sparse import splu
    sp = plan.splu_plan
    return collections.Counter(
        blk for row in splu._device_plan(sp, torch.device("cuda"))["rows"]
        if row[2] for blk in ((row[2], sp.b), (row[2], 2 * sp.b)))


def base_calls(top):
    """{(w, m): calls} of gj_inv under the top-level blocks ``top``."""
    calls = collections.Counter()
    for (w, m), c in top.items():
        out = []
        inv_block_bases(m, w, out)
        for blk in out:
            calls[blk] += c
    return calls


def gj_inputs(w, m, seed):
    """(w, m, m) f64 blocks made on the card from ``seed``, diagonally
    dominant, with exact zero pivots that the clamp must catch: lane 0 at
    step 0, and (w > 1) lane w // 2 at the last step (its last row and
    column zero)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    D = torch.randn((w, m, m), generator=g, dtype=torch.float64,
                    device="cuda")
    D.diagonal(dim1=1, dim2=2).add_(2.0 * m)
    D[0, 0, 0] = 0.0
    if w > 1:
        D[w // 2, -1, :] = 0.0
        D[w // 2, :, -1] = 0.0
    return D


def gj_work(w, m):
    """(bytes, flops) of the clamped inverse of a (w, m, m) batch: D read
    once, Dinv and the four per-lane statistics (three f64, one int32)
    written once; 2 m^3 flops a lane (m steps of an m x m rank-1 update),
    whichever base the recursion uses."""
    return 16 * w * m * m + 28 * w, 2 * m ** 3 * w


def gj_kernel_only(D, delta):
    """A launch of gj_inv's C entry point on D alone, outputs allocated
    once: the kernel's time without the wrapper's host work."""
    from russell_tpu_torch.sparse import _cuda
    w, m = D.shape[0], D.shape[-1]
    outs = [torch.empty_like(D)] + [
        torch.empty(w, dtype=t, device=D.device) for t in (
            torch.float64, torch.float64, torch.int32, torch.float64)]
    fn = _cuda.library("gj_inv").gj_inv_f64

    def launch():
        _cuda.launch_check("gj_inv", fn(
            D.data_ptr(), D.stride(0), D.stride(1), delta.data_ptr(),
            delta.numel(), w, m, *(o.data_ptr() for o in outs),
            _cuda.stream_of(D)))
    return launch


def check_gj_inv(w, m, seed, delta):
    """gj_inv against its plain version at (w, m): Dinv bit-identical,
    min|pivot|, n_perturbed and the sign exact, log|det| at rtol 1e-14
    (both sum it in step order; the card's log and the CPU's may round
    apart), and the zero pivots clamped. Returns (max |Dinv - plain|,
    max relative log|det| error)."""
    from russell_tpu_torch.sparse import splu
    D = gj_inputs(w, m, seed)
    got = splu._gj_inv(D, delta)
    want = splu._gj_inv_plain(D, delta)
    err = float((got[0] - want[0]).abs().max())
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"gj_inv ({w}, {m}): Dinv differs from the "
                             f"plain version by up to {err}")
    ld_err = float(((got[1] - want[1]).abs() / want[1].abs()).max())
    torch.testing.assert_close(got[1], want[1], rtol=1e-14, atol=0,
                               msg=lambda s: f"gj_inv ({w}, {m}) log|det|: "
                               f"{s}")
    for name, g, p in (("min|pivot|", got[2], want[2]),
                       ("n_perturbed", got[3], want[3]),
                       ("sign", got[4], want[4])):
        if not torch.equal(g, p):
            raise AssertionError(f"gj_inv ({w}, {m}): {name} differs from "
                                 "the plain version")
    npert = int(got[3].sum())
    if npert != (1 if w == 1 else 2) or float(got[2].min()) != 0.0:
        raise AssertionError(f"gj_inv ({w}, {m}): the zero pivots were not "
                             f"clamped ({npert} perturbed)")
    return err, ld_err


def check_gj_inv_shapes(tops):
    """``check_gj_inv`` at every (w, m) of the base calls under each plan's
    top-level blocks ``tops`` ({plan: {(w, m): calls}}), each shape once.
    Returns (max |Dinv - plain|, max relative log|det| error)."""
    from russell_tpu_torch.sparse import splu
    delta = torch.tensor(1e-14, dtype=torch.float64, device="cuda")
    max_err, ld_err, checked = 0.0, 0.0, set()
    for name, top in tops.items():
        calls = base_calls(top)
        for (w, m) in sorted(calls):
            if (w, m) in checked:
                continue
            checked.add((w, m))
            err, lde = check_gj_inv(w, m, w * 100 + m, delta)
            max_err, ld_err = max(max_err, err), max(ld_err, lde)
        say("gj_inv_shapes", plan=name, gj_max_m=splu.GJ_MAX_M,
            calls=sum(calls.values()),
            shapes=[[w, m, c] for (w, m), c in sorted(calls.items())])
    say("gj_inv_check", plans=list(tops), shapes=len(checked),
        max_abs_err=max_err, logdet_max_rel_err=ld_err, bit_identical=True)
    torch.cuda.empty_cache()
    return max_err, ld_err


def summed_times(calls, fn, reps=REPS, cold=False, warmup=3):
    """Sum over {(w, m): calls} of calls x the device time of ``fn(D)``
    on ``gj_inputs(w, m)`` (back to back, or L2-cold)."""
    delta = torch.tensor(1e-14, dtype=torch.float64, device="cuda")
    tot = 0.0
    for (w, m), c in sorted(calls.items()):
        D = gj_inputs(w, m, w + m)
        big = w * m * m > 1 << 24
        call = fn(D, delta)
        tot += c * (cold_ms if cold else time_ms)(
            call, reps=min(reps, 3) if big else reps,
            warmup=1 if big else warmup)
        del D, call
    torch.cuda.empty_cache()
    return tot


def inv_block_pair(name, top):
    """One factorize pair's pivot inverses, ``top`` its {(w, m): calls} of
    ``splu._inv_block``: the gj_inv kernel's device time and launches
    (its base calls), _inv_block's whole device time and device launches
    (the kernel and the recursion's GEMMs, cats and adds), both against
    the bound of the top-level blocks (gj_work: 2 m^3 a lane, whatever
    the base) and against torch.linalg.inv_ex on the same top-level blocks
    (unclamped)."""
    from russell_tpu_torch.sparse import splu
    base = base_calls(top)
    nbytes = sum(c * gj_work(w, m)[0] for (w, m), c in top.items())
    flops = sum(c * gj_work(w, m)[1] for (w, m), c in top.items())
    b_ms, b_by = bound(nbytes, flops)
    ms = summed_times(base, lambda D, d: gj_kernel_only(D, d))
    inv_ms = summed_times(top, lambda D, d: (lambda: splu._inv_block(D, d)))
    lib_ms = summed_times(top, lambda D, d: (
        lambda: torch.linalg.inv_ex(D)))
    # device launches of the pair's _inv_block calls, in one profiled run
    delta = torch.tensor(1e-14, dtype=torch.float64, device="cuda")
    blocks = [(gj_inputs(w, m, w + m), c) for (w, m), c in top.items()]

    def all_calls():
        for D, c in blocks:
            for _ in range(c):
                splu._inv_block(D, delta)
    all_calls()
    n0 = gj_inv_launches()
    launches = kernel_device_ms(all_calls)[2]
    if gj_inv_launches() - n0 != sum(base.values()):
        raise AssertionError(f"{name}: gj_inv launched "
                             f"{gj_inv_launches() - n0} times for "
                             f"{sum(base.values())} base calls")
    del blocks
    torch.cuda.empty_cache()
    rec = {"pair": name, "top_blocks": sum(top.values()),
           "gj_inv_launches": sum(base.values()), "gj_inv_ms": ms,
           "inv_block_ms": inv_ms, "inv_block_launches": launches,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops, "inv_block_share": b_ms / inv_ms,
           "library_ms": lib_ms,
           "top_w_m_calls": [[w, m, c] for (w, m), c in sorted(top.items())],
           "base_w_m_calls": [[w, m, c]
                              for (w, m), c in sorted(base.items())]}
    say("inv_block_pair", **rec)
    return rec


def phase_gj_inv(splu_plan, gplans):
    """gj_inv against its plain version on the card at every (w, m) of its
    base calls in one npoint-129 SPLU factorize pair and in one GRIDMF
    factorize pair at npoint 129 and 513 (and 513 at leaf 16), with clamped
    lanes; then, per factorize pair (GRIDMF 129 and 513, SPLU 129), the
    kernel's and _inv_block's device time and launches beside the bound of
    the top-level blocks and torch.linalg.inv_ex on them
    (``inv_block_pair``); and, at the npoint-129 GRIDMF pair's base calls,
    the kernel's L2-cold time, its plain version's and inv_ex's on the same
    blocks, and the bound of that work. Returns the kernels line's
    numbers."""
    from russell_tpu_torch.sparse import splu
    delta = torch.tensor(1e-14, dtype=torch.float64, device="cuda")
    tops = {"splu_129": splu_top_blocks(splu_plan)}
    for key, gp in gplans.items():
        tops[f"gridmf_{key}"] = gridmf_top_blocks(gp)
    max_err, ld_err = check_gj_inv_shapes(tops)
    pairs = {name: inv_block_pair(name, tops[name]) for name in (
        "gridmf_129", "gridmf_513", "splu_129")}
    # the kernel alone at the npoint-129 GRIDMF pair's base calls
    base = base_calls(tops["gridmf_129"])
    nbytes = sum(c * gj_work(w, m)[0] for (w, m), c in base.items())
    flops = sum(c * gj_work(w, m)[1] for (w, m), c in base.items())
    b_ms, b_by = bound(nbytes, flops)
    res = {"max_abs_err": max_err, "ms": pairs["gridmf_129"]["gj_inv_ms"],
           "ms_cold_l2": summed_times(
               base, lambda D, d: gj_kernel_only(D, d), cold=True),
           "plain_ms": summed_times(base, lambda D, d: (
               lambda: splu._gj_inv_plain(D, d)), reps=2, warmup=1),
           "library_ms": summed_times(base, lambda D, d: (
               lambda: torch.linalg.inv_ex(D))),
           "bound_ms": b_ms, "bound_by": b_by}
    # one SPLU row's diagonal lanes: the real state (b) and the K state (2b)
    nd = max(w for (w, m) in tops["splu_129"])
    D = gj_inputs(nd, 64, 7)
    splu_row = {"lanes": nd,
                "b32_ms": time_ms(lambda: splu._gj_inv(D[:, :32, :32], delta)),
                "inv_block_2b64_ms": time_ms(lambda: splu._inv_block(D,
                                                                     delta))}
    say("gj_inv", per="npoint-129 GRIDMF factorize pair, its base calls",
        gj_max_m=splu.GJ_MAX_M, calls=sum(base.values()), bytes=nbytes,
        flops=flops, **res, share=b_ms / res["ms"],
        share_cold_l2=b_ms / res["ms_cold_l2"], splu_row=splu_row,
        logdet_max_rel_err=ld_err)
    torch.cuda.empty_cache()
    return {**res, "logdet_max_rel_err": ld_err,
            "inv_block": {k: {f: v[f] for f in (
                "gj_inv_launches", "gj_inv_ms", "inv_block_ms",
                "inv_block_launches", "bound_ms", "library_ms")}
                for k, v in pairs.items()}}


def brusselator_system(npoint):
    """The Brusselator at ``npoint``: (system, t0, y0, rows, cols) with
    Radau5's K pattern (Jacobian entries, then the mass diagonal)."""
    from russell_tpu_torch.ode import samples
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, npoint)
    ii, jj = system.jac_structure
    n = system.ndim
    return (system, t0, y0, np.concatenate([ii, np.arange(n)]),
            np.concatenate([jj, np.arange(n)]))


def gridmf_setup(npoint, leaf=None):
    """The GRIDMF plan that AUTO picks for the npoint Brusselator (or the
    one at ``leaf`` cells a leaf), with the replay's real and complex
    values on the card."""
    from russell_tpu_torch.sparse import factor
    from russell_tpu_torch.sparse.enums import Genie
    system, t0, y0, rows, cols = brusselator_system(npoint)
    n = system.ndim
    leaves = factor.GRIDMF_LEAVES
    try:
        if leaf is not None:
            factor.GRIDMF_LEAVES = (leaf,)
        t_a = time.perf_counter()
        plan = factor.analyze(n, rows, cols, grid=system.grid)
        analyze_s = time.perf_counter() - t_a
    finally:
        factor.GRIDMF_LEAVES = leaves
    if plan.genie != Genie.GRIDMF:
        raise AssertionError(f"AUTO picked {plan.genie} at npoint {npoint}")
    jv = system.jacobian(t0, torch.as_tensor(y0), None).numpy()
    dev = torch.device("cuda")
    vr = torch.as_tensor(np.concatenate([-jv, np.full(n, GAMMA)]),
                         device=dev)
    vc = torch.as_tensor(np.concatenate([-jv + 0j, np.full(n, ALPHA_BETA)]),
                         device=dev)
    return plan, vr, vc, analyze_s


def gridmf_pair_flops(gplan):
    """Flops of one GRIDMF factorize pair: the real plane's
    (``gridmf_flops``) and the complex one's (the pivot inverse on the K
    embedding, 2 (2e)^3; panel and Schur products as 3 real products
    each)."""
    from russell_tpu_torch.sparse import gridmf
    cplx = sum(lv.n_nodes * (16 * lv.e ** 3 + 6 * lv.r * lv.e * lv.e
                             + 6 * lv.r * lv.r * lv.e)
               for lv in gplan.levels)
    return gridmf.gridmf_flops(gplan), gridmf.gridmf_flops(gplan) + cplx


def residual(plan, vals, x, b):
    """max |A x - b| / max |b| with A the entries ``vals`` at the plan's
    (rows, cols), on the card."""
    rows = torch.as_tensor(plan.rows, device=x.device)
    cols = torch.as_tensor(plan.cols, device=x.device)
    ax = torch.zeros(plan.n, dtype=x.dtype, device=x.device).index_add_(
        0, rows, vals * x[cols])
    return float((ax - b).abs().max() / b.abs().max())


def gridmf_pair_record(plan, vr, vc, pairs=3):
    """One GRIDMF factorize pair and one solve pair on the card, after a
    warm-up pair: wall (median of ``pairs``), device time and device
    launches per pair under the profiler, gj_inv launches per pair, peak
    memory, the residuals of both systems."""
    from russell_tpu_torch.sparse import factor, gridmf
    gp = plan.gridmf_plan
    rng = np.random.default_rng(SEED)
    n = plan.n
    br = torch.as_tensor(rng.standard_normal(n), device=vr.device)
    bc = torch.complex(br, torch.as_tensor(rng.standard_normal(n),
                                           device=vr.device))

    def fact():
        return factor.numeric_factorize_pair(plan, vr, vc)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fr, fc = fact()
    torch.cuda.synchronize()
    walls = []
    for _ in range(pairs):
        del fr, fc
        t0 = time.perf_counter()
        fr, fc = fact()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    n0 = gj_inv_launches()
    fact()
    torch.cuda.synchronize()
    gj_per_pair = gj_inv_launches() - n0
    ms, prof_wall, launches = kernel_device_ms(fact)

    def solve():
        return factor.factor_solve_pair(plan, fr, fc, br, bc, refine_steps=0)

    xr, xc = solve()
    torch.cuda.synchronize()
    s_walls = []
    for _ in range(pairs):
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        s_walls.append(time.perf_counter() - t0)
    s_ms, _, s_launches = kernel_device_ms(solve)
    res = {"real": residual(plan, vr, xr, br),
           "complex": residual(plan, vc, xc, bc)}
    for k, v in res.items():
        if not v <= 1e-10:
            raise AssertionError(f"GRIDMF {k} residual {v} > 1e-10")
    real_flops, pair_flops = gridmf_pair_flops(gp)
    dev_ms = sum(ms.values())
    return {"leaf_e": gp.levels[-1].e, "depths": len(gp.levels),
            "factorize_pair_wall_ms": [1e3 * w for w in walls],
            "factorize_pair_wall_median_ms": 1e3 * statistics.median(walls),
            "factorize_pair_device_ms": dev_ms,
            "factorize_pair_device_busy_share": dev_ms / (1e3 * prof_wall),
            "factorize_pair_profiled_wall_ms": 1e3 * prof_wall,
            "factorize_pair_device_launches": launches,
            "gj_inv_launches_per_pair": gj_per_pair,
            "gj_inv_device_ms": summed(ms, "gj_inv"),
            "gemm_device_ms": sum(v for k, v in ms.items()
                                  if "gemm" in k.lower()),
            "top_kernels_ms": dict(sorted(ms.items(), key=lambda kv: -kv[1])
                                   [:6]),
            "solve_pair_wall_median_ms": 1e3 * statistics.median(s_walls),
            "solve_pair_device_ms": sum(s_ms.values()),
            "solve_pair_device_launches": s_launches,
            "real_plane_flops": real_flops, "pair_flops": pair_flops,
            "pair_GFLOP_per_s_device": pair_flops / dev_ms / 1e6,
            "pair_GFLOP_per_s_wall": pair_flops / statistics.median(walls)
            / 1e9,
            "store_GB_per_plane": gridmf.gridmf_store_gb(gp, 8),
            "peak_mem_bytes": peak, "residual": res}


def phase_gridmf_small():
    """Radau5 through GRIDMF on the npoint-16 Brusselator: the reference
    package's counters (its GRIDMF run equals its BANDED one there,
    tests/test_ode.py:476)."""
    from russell_tpu_torch.ode import Method, Params, samples
    from russell_tpu_torch.sparse.enums import Genie
    system, _, y0, _ = samples.brusselator_pde(ALPHA, 16)
    params = Params(Method.RADAU5)
    params.newton.genie = Genie.GRIDMF
    n0 = gj_inv_launches()
    t0 = time.perf_counter()
    sol, y = solve_radau5(system, y0, 1.0, params, "cuda")
    wall = time.perf_counter() - t0
    got = counters(sol.stats())
    say("gridmf_16", wall_s=wall, counters=got,
        gj_inv_launches=gj_inv_launches() - n0,
        y_min=float(y.min()), y_max=float(y.max()))
    want = {"n_accepted": 25, "n_rejected": 1, "n_factor": 26,
            "n_lin_sol": 68, "n_jacobian": 22}
    if sol.actual.plan.genie != Genie.GRIDMF or {
            k: got[k] for k in want} != want or not bool(
            torch.isfinite(y).all()):
        raise AssertionError(f"npoint-16 GRIDMF counters {got} != {want} "
                             "(or y not finite, or not GRIDMF)")


def default_path_runs(warm_runs):
    """The reference's default path: Radau5 with default Params (genie
    AUTO) on the npoint-129 Brusselator, which AUTO routes to GRIDMF;
    tolerances 1e-4, t in [0, 1]. Yields a record, the solver and y of a
    cold run (host analysis included), then of ``warm_runs`` fresh solvers
    whose analysis is untimed, gj_inv's launches counted from 0 in each
    run."""
    from russell_tpu_torch.ode import Method, OdeSolver, Params, samples
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT)
    params = Params(Method.RADAU5)
    params.set_tolerances(1e-4, 1e-4)
    dev = torch.device("cuda")
    for i in range(1 + warm_runs):
        run = "cold" if i == 0 else "warm"
        if run == "warm":
            sol = OdeSolver(params, system, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t_start = time.perf_counter()
        if run == "cold":
            sol = OdeSolver(params, system, dev)
        y = sol.solve(y0, t0, 1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = gj_inv_launches()
        st = sol.stats()
        got = counters(st)
        yield {"run": run, "wall_s": wall, "counters": got,
               "gj_inv_launches": launches,
               "gj_inv_launches_per_factorization": launches / max(
                   got["n_factor"], 1),
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "nanos_factor_max": st.nanos_factor_max,
               "nanos_lin_sol_max": st.nanos_lin_sol_max}, sol, y


def phase_gridmf_main_path(splu_counters, splu_y, warm_runs=2):
    """``default_path_runs`` checked: the plan is GRIDMF, y finite, gj_inv
    launched, and the counters held to the SPLU run's (or, where they
    differ, y to rtol 1e-6 of its y)."""
    from russell_tpu_torch.sparse.enums import Genie
    runs = []
    for rec, sol, y in default_path_runs(warm_runs):
        runs.append(rec)
        got, launches = rec["counters"], rec["gj_inv_launches"]
        say("gridmf_main_path", npoint=NPOINT, ndim=sol.ndim,
            genie=str(sol.actual.plan.genie), **rec,
            y_min=float(y.min()), y_max=float(y.max()))
        if sol.actual.plan.genie != Genie.GRIDMF:
            raise AssertionError("default Params did not route to GRIDMF")
        if tuple(y.shape) != (sol.ndim,) or not bool(
                torch.isfinite(y).all()):
            raise AssertionError("GRIDMF main path: y is not finite of "
                                 f"shape ({sol.ndim},)")
        if launches <= 0:
            raise AssertionError("GRIDMF main path: gj_inv was not launched")
        y_err = float(((y - splu_y).abs() / splu_y.abs()).max())
        if got != splu_counters:
            say("gridmf_vs_splu_counters", gridmf=got, splu=splu_counters,
                y_max_rel_err=y_err)
            if not y_err <= 1e-6:
                raise AssertionError(f"GRIDMF y differs from SPLU's by "
                                     f"{y_err} (rtol 1e-6)")
    warm = [r["wall_s"] for r in runs[1:]]
    say("gridmf_main_path_summary", npoint=NPOINT, cold_wall_s=runs[0][
        "wall_s"], warm_walls_s=warm, warm_median_s=statistics.median(warm),
        warm_spread_s=max(warm) - min(warm), counters=runs[-1]["counters"],
        splu_counters=splu_counters, counters_equal=runs[-1][
            "counters"] == splu_counters,
        y_max_rel_err_vs_splu=y_err, gj_inv_launches=runs[-1][
            "gj_inv_launches"])
    return runs, y.cpu()


def phase_gridmf_layers(leaves=(16, 32, 64)):
    """At npoint 129 and 513: one GRIDMF factorize pair and one solve pair
    (``gridmf_pair_record``) at the leaf AUTO picks, then the leaf sweep:
    the same at each leaf of ``leaves``. Returns the GRIDMF plans AUTO
    picked, by npoint, and the npoint-513 leaf-16 plan (its base calls
    reach 4,096 lanes) as "513_leaf16"."""
    plans = {}
    for npoint in (NPOINT, NPOINT_BSR):
        plan, vr, vc, analyze_s = gridmf_setup(npoint)
        plans[npoint] = plan.gridmf_plan
        rec = gridmf_pair_record(plan, vr, vc)
        say("gridmf_layers", npoint=npoint, ndim=plan.n,
            analyze_s=analyze_s, **rec)
        del plan, vr, vc
        torch.cuda.empty_cache()
        for leaf in leaves:
            plan, vr, vc, analyze_s = gridmf_setup(npoint, leaf)
            if npoint == NPOINT_BSR and leaf == 16:
                plans["513_leaf16"] = plan.gridmf_plan
            rec = gridmf_pair_record(plan, vr, vc, pairs=2)
            say("gridmf_leaf_sweep", npoint=npoint, leaf_cells=leaf,
                analyze_s=analyze_s, **{k: rec[k] for k in (
                    "leaf_e", "depths", "factorize_pair_wall_median_ms",
                    "factorize_pair_device_ms", "solve_pair_wall_median_ms",
                    "store_GB_per_plane", "peak_mem_bytes",
                    "pair_GFLOP_per_s_device", "residual")})
            del plan, vr, vc
            torch.cuda.empty_cache()
    return plans


def brusselator_jacobian(npoint):
    """J(y0) of the Brusselator at ``npoint`` as a host COO: the matrix
    whose BSR products the reference's yardstick names (BASELINE.json,
    "SpMV/SpMM nnz/s per chip"; bench.py:141-146 at npoint 513)."""
    from russell_tpu_torch.ode import samples
    from russell_tpu_torch.sparse import CooMatrix
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, npoint)
    ii, jj = system.jac_structure
    jv = system.jacobian(t0, torch.as_tensor(y0), None).numpy()
    return CooMatrix.from_arrays(system.ndim, system.ndim, ii, jj, jv)


def scipy_csr(coo):
    """The independent host answer: scipy's CSR of ``coo`` (duplicates
    summed)."""
    import scipy.sparse as sps
    ii, jj, vv = coo.triplets()
    return sps.csr_matrix((vv, (ii, jj)), shape=(coo.nrow, coo.ncol))


def torch_csr(a, dev):
    """scipy CSR ``a`` as a torch sparse CSR tensor on ``dev``, for the
    library yardsticks only (the port never calls them)."""
    return torch.sparse_csr_tensor(
        torch.as_tensor(a.indptr, dtype=torch.int64),
        torch.as_tensor(a.indices, dtype=torch.int64),
        torch.as_tensor(a.data), a.shape, device=dev)


def value_cost(t):
    """(bytes, flops of a product-add) of one value of ``t``'s dtype: 8
    and 2 for float64, 16 and 8 for complex128."""
    return t.element_size(), 8 if t.is_complex() else 2


def bsr_work(lay, m):
    """(bytes, flops) of the least work of Y = A X with X (n_cols, m), A
    given by its live layout ``lay``: each live nonzero read once (value,
    4-byte column; pads not counted), the row structure the kernels read
    (n_slices + 1 int64 slice offsets, 16x less than a CSR row pointer), X
    read and Y written once; a product-add per nonzero and column of X (2
    flops real, 8 complex)."""
    vb, fl = value_cost(lay.val)
    return ((vb + 4) * lay.nnz + 8 * (lay.n_slices + 1)
            + vb * m * (lay.n_rows + lay.n_cols), fl * lay.nnz * m)


def bsr_stored_work(bsr, m):
    """(bytes, flops) of Y = A X counted over every entry of the live
    blocks, zeros included, as a kernel that streams the stored blocks
    reads them: the bound such kernels were held to, kept for the
    record."""
    live = int((bsr.mask > 0).sum())
    return (8 * (live * bsr.bm * bsr.bn + (bsr.n_cols + bsr.n_rows) * m)
            + 12 * bsr.col_ids.numel(), 2 * live * bsr.bm * bsr.bn * m)


def first_call_s(fn):
    """Host seconds of ``fn``'s first call up to a synchronize: for
    bsr_matvec on a new matrix, the build of its live layout and one
    launch (~0.02 ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bit_identical(name, fn, first):
    """Raise unless two more launches of ``fn`` give ``first``'s bits."""
    for _ in range(2):
        if not torch.equal(fn(), first):
            raise AssertionError(f"{name}: two launches differ")


def spgemm_products(a, b):
    """Live scalar products of C = A B over the matrices' SpGEMM layouts
    (built by their first ``spgemm``): for each entry of A whose column k
    is a row of B, the entries of B's row k."""
    from russell_tpu_torch.sparse import kernels
    ra, rb = kernels._spgemm_layout(a), kernels._spgemm_layout(b)
    k = ra.col.long()
    return int(torch.diff(rb.row_ptr)[k[k < rb.n_rows]].sum())


def spgemm_work(plan, a, b):
    """(bytes, flops) of the least work of C = A B in the reference's output
    form: the live entries of each distinct operand once (value, 4-byte
    column) with its row structure (int64 row pointer), the C block columns
    (int32) and block-row pointer (int64), C written once (bm bn values a C
    block); a product-add per live scalar product (2 flops real, 8
    complex)."""
    from russell_tpu_torch.sparse import kernels
    lays = {id(m): kernels._spgemm_layout(m) for m in (a, b)}
    nbr = int(plan.c_block_ij[-1, 0]) + 1
    vb, fl = value_cost(a.blocks)
    return (sum((vb + 4) * lay.nnz + 8 * (lay.n_rows + 1)
                for lay in lays.values())
            + 4 * plan.c_blocks + 8 * (nbr + 1)
            + vb * a.bm * b.bn * plan.c_blocks, fl * spgemm_products(a, b))


def spgemm_stored_work(plan, a):
    """(bytes, flops) of A·A over ``plan`` counted over whole stored blocks,
    as a kernel of block products reads them: each distinct block the
    products use read once, the plan's index arrays, each C block written
    once; 2 bm bk bn flops per block product. The bound the earlier
    block-product kernel was held to, kept for the record."""
    n_ops = len(plan.a_idx)
    tiles = np.unique(np.concatenate([plan.a_idx, plan.b_idx])).size
    blk = a.bm * a.bn
    return (8 * blk * (tiles + plan.c_blocks)
            + 4 * (2 * n_ops + plan.c_blocks + 1),
            2 * n_ops * a.bm * a.bn * a.bn)


def spgemm_record(plan, a, first_s):
    """What the phases print of A·A beyond ``bsr_timings``: the stored-block
    bound, the live products and layout, the first call on the new matrix
    (layout build, plan upload and one launch; ``first_s``) and the first
    after an in-place update of its blocks, which rebuilds the layout."""
    from russell_tpu_torch.sparse import kernels
    lay = kernels._spgemm_layout(a)
    a.blocks.mul_(1.0)
    _, updated_s = first_call_s(lambda: kernels.spgemm(plan, a, a))
    return {"stored_bound_ms": bound(*spgemm_stored_work(plan, a))[0],
            "first_call_s": first_s, "updated_call_s": updated_s,
            "live_products": spgemm_products(a, a), "nnz_live": lay.nnz,
            "layout_bytes": lay.nbytes, "block_products": len(plan.a_idx),
            "c_blocks": plan.c_blocks,
            "strip": kernels._strip_chunks(a.bm, a.bn, kernels._device_plan(
                plan, a.blocks.device)["max_row_blocks"])}


def layout_record(lay, layout_s):
    """What the smoke prints of a matrix's live layout ``lay`` (built by
    its first bsr_matvec in ``layout_s`` s)."""
    return {"layout_s": layout_s, "nnz_live": lay.nnz,
            "slots": lay.val.numel(), "pad_share": lay.pad_share,
            "slices": lay.n_slices, "layout_bytes": lay.nbytes}


def library_or_none(lib):
    """``lib`` if one call of it runs on this card's PyTorch, else None
    (a yardstick only: a complex sparse product may not be implemented)."""
    try:
        lib()
        torch.cuda.synchronize()
        return lib
    except (RuntimeError, NotImplementedError) as exc:
        say("library_unavailable", error=str(exc)[:300])
        return None


def bsr_timings(kern, plain, lib, work, ms_warm=None):
    """The numbers of a BSR product that the kernels line takes: ``ms``,
    ``plain_ms`` and ``library_ms`` with the L2 flushed before each call
    (``cold_ms``; SpMV's whole working set at npoint 513 fits the 50 MB
    L2, so back-to-back calls would partly read it from there, not from
    HBM as the bound assumes), the kernel's and the library's back-to-back
    times (``time_ms``, L2 warm) beside them, and the bound of ``work``."""
    ms = cold_ms(kern)
    if ms_warm is None:
        ms_warm = time_ms(kern)
    plain_ms = cold_ms(plain)
    torch.cuda.empty_cache()
    b_ms, b_by = bound(*work)
    lib = library_or_none(lib)
    return {"ms": ms, "ms_warm_l2": ms_warm, "plain_ms": plain_ms,
            "library_ms": None if lib is None else cold_ms(lib),
            "library_ms_warm_l2": None if lib is None else time_ms(lib),
            "bound_ms": b_ms, "bound_by": b_by}


def phase_bsr_kernels():
    """Each BSR kernel against its plain version on the npoint-129
    Jacobian, with the numbers of ``bsr_timings`` and, for SpMV / SpMM, the
    live layout's build time and pad share and the earlier stored-block
    bound (printed here; the kernels line takes ``bsr_path``'s)."""
    from russell_tpu_torch.sparse import kernels
    dev = torch.device("cuda")
    coo = brusselator_jacobian(NPOINT)
    a_csr = torch_csr(scipy_csr(coo), dev)
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.standard_normal(coo.ncol), device=dev)
    X = torch.as_tensor(rng.standard_normal((coo.ncol, SPMM_M)), device=dev)
    bsr8 = kernels.bsr_from_coo(coo, 8, 128, dev)
    _, layout_s = first_call_s(lambda: kernels.bsr_matvec(bsr8, x))
    live = kernels._live_layout(bsr8)
    lay = layout_record(live, layout_s)
    bsr16 = kernels.bsr_from_coo(coo, 16, 16, dev)
    plan = kernels.spgemm_plan(bsr16, bsr16)
    _, spgemm_first_s = first_call_s(
        lambda: kernels.spgemm(plan, bsr16, bsr16))
    say("bsr_shapes", npoint=NPOINT, n=coo.nrow, coo_entries=coo.nnz,
        bsr8=[bsr8.nbr, bsr8.blocks_per_row, int((bsr8.mask > 0).sum())],
        bsr16=[bsr16.nbr, bsr16.blocks_per_row,
               int((bsr16.mask > 0).sum())],
        spgemm_ops=len(plan.a_idx), c_blocks=plan.c_blocks, **lay)
    # torch's CUDA BSR product takes square blocks only, so the SpMV and
    # SpMM yardsticks are the CSR products (cuSPARSE SpMV / SpMM)
    cases = {
        "bsr_spmv": (lambda: kernels.bsr_matvec(bsr8, x),
                     lambda: kernels._bsr_matvec_plain(bsr8, x),
                     lambda: a_csr @ x, bsr_work(live, 1),
                     bsr_stored_work(bsr8, 1)),
        "bsr_spmm": (lambda: kernels.bsr_matmat(bsr8, X),
                     lambda: kernels._bsr_matmat_plain(bsr8, X),
                     lambda: a_csr @ X, bsr_work(live, SPMM_M),
                     bsr_stored_work(bsr8, SPMM_M)),
        "spgemm_blocks": (
            lambda: kernels.spgemm(plan, bsr16, bsr16)[0],
            lambda: kernels._spgemm_plain(plan, bsr16, bsr16),
            lambda: torch.sparse.mm(a_csr, a_csr),
            spgemm_work(plan, bsr16, bsr16), None),
    }
    for name, (kern, plain, lib, work, stored) in cases.items():
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err, scale = assert_close(name, got, want)
        bit_identical(name, kern, got)
        t = bsr_timings(kern, plain, lib, work)
        extra = ({"stored_bound_ms": bound(*stored)[0]} if stored else
                 spgemm_record(plan, bsr16, spgemm_first_s))
        say("bsr_kernel", name=name, npoint=NPOINT, scale=scale, rtol=RTOL,
            bytes=work[0], flops=work[1], max_abs_err=err, **t,
            share=t["bound_ms"] / t["ms"],
            share_warm_l2=t["bound_ms"] / t["ms_warm_l2"],
            bit_identical=True, **extra)
    torch.cuda.empty_cache()


def phase_bsr_path():
    """The BSR path through the public entry points on the npoint-513
    Jacobian. Each result is held against its kernel's plain version on
    the same inputs (every output entry, every C block) and against scipy
    on the host; the kernel, plain and library calls are timed at these
    shapes (``bsr_timings``)."""
    from russell_tpu_torch.sparse import (bsr_from_coo, bsr_matmat,
                                          bsr_matvec, kernels, spgemm,
                                          spgemm_plan)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    coo = brusselator_jacobian(NPOINT_BSR)
    a = scipy_csr(coo)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    x_h = rng.standard_normal(coo.ncol)
    X_h = rng.standard_normal((coo.ncol, SPMM_M))
    x = torch.as_tensor(x_h, device=dev)
    X = torch.as_tensor(X_h, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()

    t0 = time.perf_counter()
    bsr8 = bsr_from_coo(coo, 8, 128, dev)
    torch.cuda.synchronize()
    bsr8_s = time.perf_counter() - t0
    y, layout_s = first_call_s(lambda: bsr_matvec(bsr8, x))
    spmv_ms = time_ms(lambda: bsr_matvec(bsr8, x))
    Y = bsr_matmat(bsr8, X)
    spmm_ms = time_ms(lambda: bsr_matmat(bsr8, X))
    t0 = time.perf_counter()
    bsr16 = bsr_from_coo(coo, 16, 16, dev)
    torch.cuda.synchronize()
    bsr16_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = spgemm_plan(bsr16, bsr16)
    plan_s = time.perf_counter() - t0
    (C, cij), spgemm_first_s = first_call_s(
        lambda: spgemm(plan, bsr16, bsr16))
    spgemm_ms = time_ms(lambda: spgemm(plan, bsr16, bsr16))
    torch.cuda.synchronize()
    launches = {"bsr_spmv": bsr_matvec.launches,
                "bsr_spmm": bsr_matmat.launches,
                "spgemm_blocks": spgemm.launches}
    peak = torch.cuda.max_memory_allocated()
    for name, k in launches.items():
        if k <= 0:
            raise AssertionError(f"bsr_path: {name} was not launched")

    # each kernel against its plain version on the same inputs, in full;
    # two more launches give the same bits
    a_csr = torch_csr(a, dev)
    live = kernels._live_layout(bsr8)
    lay = layout_record(live, layout_s)
    # torch's CUDA BSR product takes square blocks only, so the SpMV and
    # SpMM yardsticks are the CSR products (cuSPARSE SpMV / SpMM)
    cases = {
        "bsr_spmv": (y, spmv_ms, lambda: bsr_matvec(bsr8, x),
                     lambda: kernels._bsr_matvec_plain(bsr8, x),
                     lambda: a_csr @ x, bsr_work(live, 1),
                     bsr_stored_work(bsr8, 1)),
        "bsr_spmm": (Y, spmm_ms, lambda: bsr_matmat(bsr8, X),
                     lambda: kernels._bsr_matmat_plain(bsr8, X),
                     lambda: a_csr @ X, bsr_work(live, SPMM_M),
                     bsr_stored_work(bsr8, SPMM_M)),
        "spgemm_blocks": (
            C, spgemm_ms, lambda: spgemm(plan, bsr16, bsr16)[0],
            lambda: kernels._spgemm_plain(plan, bsr16, bsr16),
            lambda: torch.sparse.mm(a_csr, a_csr),
            spgemm_work(plan, bsr16, bsr16), None),
    }
    # the kernels line takes ``results``: measured numbers and the bound;
    # the shares, the stored-block bound, the layouts and first calls go to
    # this phase's lines only
    results = {}
    for name, (got, ms_warm, kern, plain, lib, work,
               stored) in cases.items():
        want = plain()
        err, scale = assert_close(f"{name} vs plain", got, want)
        del want
        torch.cuda.empty_cache()
        bit_identical(name, kern, got)
        results[name] = {"max_abs_err": err,
                         **bsr_timings(kern, plain, lib, work, ms_warm)}
        t = results[name]
        extra = ({"stored_bound_ms": bound(*stored)[0],
                  "layout_s": layout_s, "pad_share": lay["pad_share"]}
                 if stored else spgemm_record(plan, bsr16, spgemm_first_s))
        say("bsr_path_kernel", name=name, npoint=NPOINT_BSR, scale=scale,
            rtol=RTOL, **t, share=t["bound_ms"] / t["ms"],
            share_warm_l2=t["bound_ms"] / t["ms_warm_l2"],
            bit_identical=True, **extra)
    del a_csr
    torch.cuda.empty_cache()

    # independent answers: scipy's CSR products on the host
    t0 = time.perf_counter()
    err_y, scale_y = assert_close("bsr_matvec vs scipy", y, a @ x_h)
    err_Y, scale_Y = assert_close("bsr_matmat vs scipy", Y, a @ X_h)
    a2 = (a @ a).tocsr()
    b = bsr16.bm
    n = coo.nrow
    sample = sorted({0, bsr16.nbr - 1,
                     *rng.choice(bsr16.nbr, 6, replace=False).tolist()})
    err_C = scale_C = 0.0
    for i in sample:
        lo, hi = np.searchsorted(cij[:, 0], [i, i + 1])
        r0, r1 = i * b, min((i + 1) * b, n)
        got = np.zeros((b, -(-n // b) * b))
        for q, blk in zip(cij[lo:hi, 1], C[lo:hi].cpu().numpy()):
            got[:, q * b:(q + 1) * b] = blk
        e, sc = assert_close(f"spgemm block row {i} vs scipy",
                             got[: r1 - r0, :n], a2[r0:r1].toarray())
        err_C, scale_C = max(err_C, e), max(scale_C, sc)
    check_s = time.perf_counter() - t0

    nnz = a.nnz
    metrics = {}
    for name, (nbytes, flops), per in (
            ("bsr_spmv", bsr_work(live, 1), nnz),
            ("bsr_spmm", bsr_work(live, SPMM_M), nnz),
            ("spgemm_blocks", spgemm_work(plan, bsr16, bsr16), None)):
        ms, b_ms = results[name]["ms"], results[name]["bound_ms"]
        metrics[name] = {
            "ms": ms, "launches": launches[name], "bytes": nbytes,
            "flops": flops, "GB_per_s": nbytes / ms / 1e6,
            "GFLOP_per_s": flops / ms / 1e6, "bound_ms": b_ms,
            "bound_by": results[name]["bound_by"],
            "roofline_share": b_ms / ms}
        if per is not None:
            metrics[name]["nnz_per_s"] = per / ms * 1e3
    metrics["bsr_spmm"]["nnz_rhs_per_s"] = (
        nnz * SPMM_M / results["bsr_spmm"]["ms"] * 1e3)
    metrics["spgemm_blocks"]["live_products_per_s"] = (
        spgemm_products(bsr16, bsr16) / results["spgemm_blocks"]["ms"] * 1e3)
    say("bsr_path", npoint=NPOINT_BSR, n=n, nnz=nnz, coo_entries=coo.nnz,
        jacobian_and_scipy_s=setup_s, bsr_from_coo_8x128_s=bsr8_s,
        bsr_from_coo_16x16_s=bsr16_s, spgemm_plan_s=plan_s,
        check_s=check_s,
        bsr8={"nbr": bsr8.nbr, "bpr": bsr8.blocks_per_row,
              "live_blocks": int((bsr8.mask > 0).sum()),
              "stored_GB": bsr8.blocks.numel() * 8 / 1e9, **lay},
        bsr16={"nbr": bsr16.nbr, "bpr": bsr16.blocks_per_row,
               "live_blocks": int((bsr16.mask > 0).sum())},
        spgemm_ops=len(plan.a_idx), c_blocks=plan.c_blocks,
        C_GB=C.numel() * 8 / 1e9, spmm_m=SPMM_M,
        err_vs_scipy={"y": err_y, "y_scale": scale_y, "Y": err_Y,
                      "Y_scale": scale_Y, "C": err_C, "C_scale": scale_C,
                      "C_block_rows": sample},
        peak_mem_bytes=peak, **metrics)
    return launches, results


def complex_jacobian(npoint):
    """J(y0) + i 0.3 noise (seeded) as a host COO: a complex128 matrix of
    the Jacobian's pattern, as Radau5's (alpha + i beta) M - J is."""
    from russell_tpu_torch.sparse import CooMatrix
    coo = brusselator_jacobian(npoint)
    ii, jj, vv = (np.asarray(v) for v in coo.triplets())
    rng = np.random.default_rng(SEED + npoint)
    return CooMatrix.from_arrays(coo.nrow, coo.ncol, ii, jj,
                                 vv + 0.3j * rng.standard_normal(len(vv)))


def phase_bsr_complex():
    """The three BSR products on complex128 matrices (``complex_jacobian``
    at npoint 129 and 513) through the public entry points: each held to
    its plain version on the card (every entry) and to scipy on the host
    (y and Y in full, 8 block rows of C), launched twice more for bit
    identity, and timed L2-cold beside the bound and the library call
    (``bsr_timings``). Returns the npoint-513 numbers for the kernels
    line."""
    from russell_tpu_torch.sparse import (bsr_from_coo, bsr_matmat,
                                          bsr_matvec, kernels, spgemm,
                                          spgemm_plan)
    dev = torch.device("cuda")
    out = {}
    for npoint in (NPOINT, NPOINT_BSR):
        coo = complex_jacobian(npoint)
        a = scipy_csr(coo)
        rng = np.random.default_rng(SEED)
        x_h = rng.standard_normal(coo.ncol) + 1j * rng.standard_normal(
            coo.ncol)
        X_h = (rng.standard_normal((coo.ncol, SPMM_M))
               + 1j * rng.standard_normal((coo.ncol, SPMM_M)))
        x = torch.as_tensor(x_h, device=dev)
        X = torch.as_tensor(X_h, device=dev)
        reset_launch_counts()
        bsr8 = bsr_from_coo(coo, 8, 128, dev)
        y = bsr_matvec(bsr8, x)
        Y = bsr_matmat(bsr8, X)
        live = kernels._live_layout(bsr8)
        if live.val.dtype != torch.complex128:
            raise AssertionError("the live layout lost the complex values")
        a_csr = torch_csr(a, dev)
        results = {}
        for name, got, kern, plain, lib, work, want_h in (
                ("bsr_spmv", y, lambda: bsr_matvec(bsr8, x),
                 lambda: kernels._bsr_matvec_plain(bsr8, x),
                 lambda: a_csr @ x, bsr_work(live, 1), a @ x_h),
                ("bsr_spmm", Y, lambda: bsr_matmat(bsr8, X),
                 lambda: kernels._bsr_matmat_plain(bsr8, X),
                 lambda: a_csr @ X, bsr_work(live, SPMM_M), a @ X_h)):
            err, scale = assert_close(f"c128 {name} vs plain", got, plain())
            torch.cuda.empty_cache()
            err_s, _ = assert_close(f"c128 {name} vs scipy", got, want_h)
            bit_identical(f"c128 {name}", kern, got)
            results[name] = {"max_abs_err": err, "err_vs_scipy": err_s,
                             "scale": scale,
                             **bsr_timings(kern, plain, lib, work)}
        del bsr8, y, Y, live
        torch.cuda.empty_cache()
        bsr16 = bsr_from_coo(coo, 16, 16, dev)
        plan = spgemm_plan(bsr16, bsr16)
        C, cij = spgemm(plan, bsr16, bsr16)
        err, scale = assert_close("c128 spgemm vs plain", C,
                                  kernels._spgemm_plain(plan, bsr16, bsr16))
        torch.cuda.empty_cache()
        bit_identical("c128 spgemm", lambda: spgemm(plan, bsr16, bsr16)[0],
                      C)
        a2 = (a @ a).tocsr()
        b, n = bsr16.bm, coo.nrow
        err_s = 0.0
        for i in sorted({0, bsr16.nbr - 1, *rng.choice(
                bsr16.nbr, 6, replace=False).tolist()}):
            lo, hi = np.searchsorted(cij[:, 0], [i, i + 1])
            r0, r1 = i * b, min((i + 1) * b, n)
            got = np.zeros((b, -(-n // b) * b), np.complex128)
            for q, blk in zip(cij[lo:hi, 1], C[lo:hi].cpu().numpy()):
                got[:, q * b:(q + 1) * b] = blk
            err_s = max(err_s, assert_close(
                f"c128 spgemm block row {i} vs scipy", got[: r1 - r0, :n],
                a2[r0:r1].toarray())[0])
        del C
        results["spgemm_blocks"] = {
            "max_abs_err": err, "err_vs_scipy": err_s, "scale": scale,
            **bsr_timings(lambda: spgemm(plan, bsr16, bsr16)[0],
                          lambda: kernels._spgemm_plain(plan, bsr16, bsr16),
                          lambda: torch.sparse.mm(a_csr, a_csr),
                          spgemm_work(plan, bsr16, bsr16))}
        launches = {"bsr_spmv": bsr_matvec.launches,
                    "bsr_spmm": bsr_matmat.launches,
                    "spgemm_blocks": spgemm.launches}
        for name, t in results.items():
            say("bsr_complex", name=name, npoint=npoint, n=coo.nrow,
                nnz=a.nnz, dtype="complex128", rtol=RTOL, **t,
                share=t["bound_ms"] / t["ms"], launches=launches[name],
                bit_identical=True)
        out[npoint] = results
        del bsr16, plan, a_csr
        torch.cuda.empty_cache()
    return out[NPOINT_BSR]

# -- the ODE surface: samples, ERK, BwEuler and the DENSE route --------------

NPOINT_DENSE = 24     # ndim 1,152 <= dense_threshold: AUTO takes DENSE
ERK_WINDOW_X1 = 0.05  # the profiled window of the npoint-513 DoPri5 run
BWEULER_H = 0.01      # BwEuler's equal step (PERF.md §5: 0.1 diverges)


def ode_run(name, sample, method, x1=None, h_ini=None, tol=None,
            dense_h=None, h_equal=None, sample_args=(), y0=None, x0=None):
    """One OdeSolver run on the card with default Params apart from the
    named ones; returns (record, solver, y on the host, dense Output or
    None)."""
    from russell_tpu_torch.ode import Method, OdeSolver, Output, Params
    from russell_tpu_torch.ode import samples
    res = getattr(samples, sample)(*sample_args)
    system = res[0]
    x0 = res[1] if x0 is None else x0
    y0 = res[2] if y0 is None else y0
    if x1 is None:
        x1 = res[3]
    params = Params(Method[method])
    if h_ini is not None:
        params.step.h_ini = h_ini
    if tol is not None:
        params.set_tolerances(*tol)
    out = None
    if dense_h is not None:
        out = Output().set_dense_h_out(dense_h).set_dense_recording(
            list(range(system.ndim)))
    sol = OdeSolver(params, system, "cuda")
    t0 = time.perf_counter()
    y = sol.solve(y0, x0, x1, h_equal=h_equal, output=out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = sol.stats()
    rec = {"name": name, "method": method, "wall_s": wall,
           "counters": counters(st), "h_accepted": st.h_accepted,
           "y": y.cpu().tolist()}
    plan = getattr(sol.actual, "plan", None)
    if plan is not None:
        rec["genie"] = plan.genie.name
    return rec, sol, np.asarray(rec["y"]), out


def phase_ode_samples():
    """The Fortran oracles of tests/test_ode.py on the card, through the
    default genie AUTO (DENSE for these small systems): counters exact, y
    within the tolerances given there."""
    from russell_tpu_torch.ode import samples
    runs, bad = [], []

    def check(rec, want, y_want=(), h_want=None):
        """want: {counter: value}; y_want: [(index, value, tol)]."""
        got = {k: rec["counters"][k] for k in want}
        if got != want:
            bad.append(f"{rec['name']}: counters {got} != {want}")
        for i, v, tol in y_want:
            if not abs(rec["y"][i] - v) < tol:
                bad.append(f"{rec['name']}: y[{i}] {rec['y'][i]} off {v} "
                           f"by >= {tol}")
        if h_want is not None and not abs(rec["h_accepted"] - h_want[0]) \
                < h_want[1]:
            bad.append(f"{rec['name']}: h_accepted {rec['h_accepted']}")
        if rec.get("genie", "DENSE") != "DENSE":
            bad.append(f"{rec['name']}: genie {rec['genie']}, not DENSE")
        runs.append(rec)

    # Radau5 (tests/test_ode.py:47, :362, :34, :97)
    rec, *_ = ode_run("radau5_van_der_pol", "van_der_pol", "RADAU5",
                      h_ini=1e-6, dense_h=0.2, sample_args=(1e-6, False))
    check(rec, {"n_function": 2249, "n_jacobian": 162, "n_factor": 253,
                "n_lin_sol": 668, "n_steps": 280, "n_accepted": 242,
                "n_rejected": 8, "n_iterations": 2, "n_iterations_max": 6},
          [(0, 1.706163410178079, 1e-12), (1, -8.927971289301175e-01,
                                           1e-11)],
          (1.510987221365367e-01, 1e-6))
    rec, *_ = ode_run("radau5_robertson", "robertson", "RADAU5", x1=0.3,
                      h_ini=1e-6, tol=(1e-8, 1e-2))
    check(rec, {"n_function": 88, "n_jacobian": 8, "n_factor": 15,
                "n_lin_sol": 24, "n_steps": 17, "n_accepted": 15,
                "n_rejected": 1},
          [(0, 9.886740138499884e-01, 1e-15), (1, 3.447720471782070e-05,
                                               1e-15),
           (2, 1.129150894529390e-02, 1e-15)], (8.160578540333708e-01,
                                                1e-10))
    y_fn = samples.hairer_wanner_eq1()[4]
    rec, *_ = ode_run("radau5_hairer_wanner", "hairer_wanner_eq1", "RADAU5",
                      x1=1.5, h_ini=1e-4)
    check(rec, {}, [(0, float(y_fn(1.5, None)[0]), 5e-5)])
    if not (rec["counters"]["n_accepted"] > 0
            and rec["counters"]["n_jacobian"] >= 1):
        bad.append("radau5_hairer_wanner: no accepted step or Jacobian")
    rec, *_ = ode_run("radau5_amplifier1t", "amplifier1t", "RADAU5", x1=0.05,
                      h_ini=1e-6, tol=(1e-4, 1e-4))
    check(rec, {"n_function": 1511, "n_jacobian": 126, "n_factor": 166,
                "n_lin_sol": 461, "n_steps": 166, "n_accepted": 127,
                "n_rejected": 6, "n_iterations_max": 5},
          [(0, -2.226517868073645e-02, 1e-10), (1, 3.068700099735197, 1e-10),
           (2, 2.898340496450958, 1e-9), (3, 2.033525366489690, 1e-7),
           (4, -2.269179823457655, 1e-7)], (7.791381954171996e-04, 1e-6))
    # DoPri5, DoPri8 (tests/test_ode.py:16, :321, :342)
    rec, _, _, out = ode_run("dopri5_hairer_wanner", "hairer_wanner_eq1",
                             "DOPRI5", x1=1.5, h_ini=1e-4, dense_h=0.1)
    check(rec, {"n_function": 235, "n_steps": 39, "n_accepted": 39,
                "n_rejected": 0}, [(0, 9.063921649310544e-02, 1e-13)])
    if len(out.dense_x()) != 16:
        bad.append("dopri5_hairer_wanner: not 16 dense stations")
    rec, *_ = ode_run("dopri5_arenstorf", "arenstorf", "DOPRI5", h_ini=1e-4,
                      tol=(1e-7, 1e-7))
    check(rec, {"n_function": 1429, "n_steps": 238, "n_accepted": 217,
                "n_rejected": 21},
          [(0, 9.940021704030663e-01, 1e-11), (1, 9.040891036151961e-06,
                                               1e-11),
           (2, 1.459758305600828e-03, 1e-9), (3, -2.001245515834718, 1e-9)],
          (5.258587607119909e-04, 1e-10))
    rec, *_ = ode_run("dopri8_van_der_pol", "van_der_pol", "DOPRI8", x1=2.0,
                      h_ini=1e-6, tol=(1e-9, 1e-9), dense_h=0.1,
                      sample_args=(1e-3, False), y0=np.array([2.0, 0.0]),
                      x0=0.0)
    check(rec, {"n_steps": 1469, "n_accepted": 1348, "n_rejected": 121,
                "n_function": 21553 - 2},
          [(0, 1.763234540172087, 1e-13), (1, -8.356886819301910e-01,
                                           1e-12)])
    # Euler (tests/test_ode.py:516, :529)
    rec, *_ = ode_run("bweuler_hairer_wanner", "hairer_wanner_eq1",
                      "BW_EULER", x1=1.5, h_equal=1.875 / 50.0)
    check(rec, {"n_function": 80, "n_jacobian": 40, "n_factor": 40,
                "n_lin_sol": 40, "n_steps": 40, "n_accepted": 40,
                "n_rejected": 0, "n_iterations_max": 2},
          [(0, 0.09060476604187756, 1e-15)])
    rec, *_ = ode_run("mdeuler_hairer_wanner", "hairer_wanner_eq1",
                      "MD_EULER", x1=1.5, h_ini=1e-4)
    check(rec, {"n_function": 424, "n_jacobian": 0, "n_factor": 0,
                "n_lin_sol": 0, "n_steps": 212, "n_accepted": 212,
                "n_rejected": 0}, [(0, 0.09062475637905158, 1e-16)])
    say("ode_samples", runs=[{k: v for k, v in r.items() if k != "y"}
                             | {"y": r["y"][:5]} for r in runs],
        failures=bad)
    if bad:
        raise AssertionError("ode_samples: " + "; ".join(bad))


def erk_brusselator(method, npoint, dev, x1=1.0, profile=False):
    """DoPri5 or DoPri8 on the npoint Brusselator (alpha ALPHA, tolerances
    1e-4, t in [0, x1]) with stiffness detection on (recorded, not raised)
    and dense stations every 0.1 handed to a callback; returns a record,
    y and the stations [(x, y on the host)]."""
    from russell_tpu_torch.ode import Method, OdeSolver, Output, Params
    from russell_tpu_torch.ode import samples
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, npoint)
    params = Params(Method[method])
    params.set_tolerances(1e-4, 1e-4)
    params.stiffness.enabled = True
    params.stiffness.stop_with_error = False
    params.stiffness.save_results = True
    stations = []

    def keep(stats, h, x, y, args):
        stations.append((x, y))
        return False

    out = Output().set_dense_h_out(0.1).set_dense_callback(keep)
    sol = OdeSolver(params, system, dev)
    rec = {"method": method, "npoint": npoint, "ndim": system.ndim,
           "device": str(dev), "x1": x1}
    if profile:
        ms, wall, launches = kernel_device_ms(
            lambda: sol.solve(y0, t0, x1, output=out))
        rec.update(profiled_wall_s=wall, device_ms=sum(ms.values()),
                   device_launches=launches)
        return rec, None, None
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_start = time.perf_counter()
    y = sol.solve(y0, t0, x1, output=out)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t_start
    st = sol.stats()
    rec.update(counters=counters(st), h_accepted=st.h_accepted,
               stiff_detected=len(out.stiff_x()) > 0,
               stiff_x=list(out.stiff_x()),
               stiff_step_index=list(out.stiff_step_index),
               stations=len(stations))
    return rec, y, stations


def phase_erk_path():
    """DoPri5 and DoPri8 on the npoint-129 Brusselator on the card and on
    the CPU in this run (counters exact, y and the dense stations at rtol
    1e-10), then DoPri5 on the npoint-513 Brusselator on the card (y
    finite); each with its wall, device launches per step and device busy
    share (the profiled run's device time over the unprofiled run's
    wall)."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    out, y_out = [], {}
    for method, npoint, with_cpu in (("DOPRI5", NPOINT, True),
                                     ("DOPRI8", NPOINT, True),
                                     ("DOPRI5", NPOINT_BSR, False)):
        rec, y, stations = erk_brusselator(method, npoint, cuda)
        n_steps = rec["counters"]["n_steps"]
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"erk_path {method} {npoint}: y not finite")
        if npoint == NPOINT:
            prof, _, _ = erk_brusselator(method, npoint, cuda, profile=True)
            rec["launches_per_step"] = prof["device_launches"] / n_steps
            rec["device_busy_share"] = prof["device_ms"] / 1e3 / rec["wall_s"]
        else:
            # a window: the whole run's trace is ~10^6 events
            win, _, _ = erk_brusselator(method, npoint, cuda,
                                        x1=ERK_WINDOW_X1)
            prof, _, _ = erk_brusselator(method, npoint, cuda,
                                         x1=ERK_WINDOW_X1, profile=True)
            w_steps = win["counters"]["n_steps"]
            rec["window"] = {"x1": ERK_WINDOW_X1, "steps": w_steps,
                             "wall_s": win["wall_s"], **{
                                 k: prof[k] for k in (
                                     "profiled_wall_s", "device_ms",
                                     "device_launches")}}
            rec["launches_per_step"] = prof["device_launches"] / w_steps
            rec["device_busy_share"] = (prof["device_ms"] / 1e3
                                        / win["wall_s"])
            rec["wall_per_step_ms"] = 1e3 * rec["wall_s"] / n_steps
        if with_cpu:
            crec, cy, cstations = erk_brusselator(method, npoint, cpu)
            rec["cpu_wall_s"] = crec["wall_s"]
            rec["counters_equal_cpu"] = crec["counters"] == rec["counters"]
            rec["y_max_rel_err_vs_cpu"] = float(
                ((y.cpu() - cy).abs() / cy.abs()).max())
            say("erk_path", **rec)
            if crec["counters"] != rec["counters"]:
                raise AssertionError(f"erk_path {method}: counters "
                                     f"{rec['counters']} != the CPU's "
                                     f"{crec['counters']}")
            torch.testing.assert_close(y.cpu(), cy, rtol=1e-10, atol=0)
            if len(stations) != len(cstations):
                raise AssertionError("erk_path: station counts differ")
            for (x, ys), (cx, cys) in zip(stations, cstations):
                if x != cx:
                    raise AssertionError(f"erk_path: station x {x} != {cx}")
                np.testing.assert_allclose(ys, cys, rtol=1e-10, atol=0)
        else:
            say("erk_path", **rec)
        out.append(rec)
        y_out[(method, npoint)] = y.cpu()
        del y
        torch.cuda.empty_cache()
    return out, y_out


def phase_bweuler_path():
    """BwEuler on the npoint-129 Brusselator with default Params (AUTO →
    GRIDMF, so gj_inv runs) and equal steps of BWEULER_H: counters, wall,
    factorizations, gj_inv launches, y finite, and the last Newton solve's
    max|A x - b| / max|b| <= 1e-10."""
    from russell_tpu_torch.ode import Method, OdeSolver, Params, samples
    from russell_tpu_torch.sparse import factor
    from russell_tpu_torch.sparse.enums import Genie
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT)
    t_a = time.perf_counter()
    sol = OdeSolver(Params(Method.BW_EULER), system, "cuda")
    analyze_s = time.perf_counter() - t_a
    if sol.actual.plan.genie != Genie.GRIDMF:
        raise AssertionError(f"BwEuler: AUTO picked {sol.actual.plan.genie}")
    last = {}
    solve = sol.actual._solve

    def solve_and_keep(r):
        last["b"], last["x"] = r, solve(r)
        return last["x"]

    sol.actual._solve = solve_and_keep
    torch.cuda.synchronize()
    reset_launch_counts()
    t_start = time.perf_counter()
    y = sol.solve(y0, t0, 1.0, h_equal=BWEULER_H)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = gj_inv_launches()
    r = factor._residual(sol.actual.plan, sol.actual._fac, last["x"],
                         last["b"])
    resid = float(r.abs().max() / last["b"].abs().max())
    st = sol.stats()
    say("bweuler_path", npoint=NPOINT, ndim=system.ndim, h_equal=BWEULER_H,
        genie=sol.actual.plan.genie.name, analyze_s=analyze_s, wall_s=wall,
        counters=counters(st), n_factor=st.n_factor,
        gj_inv_launches=launches, last_solve_residual=resid,
        nanos_factor_max=st.nanos_factor_max,
        nanos_lin_sol_max=st.nanos_lin_sol_max,
        y_min=float(y.min()), y_max=float(y.max()))
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("bweuler_path: y not finite")
    if launches <= 0:
        raise AssertionError("bweuler_path: gj_inv was not launched")
    if not resid <= 1e-10:
        raise AssertionError(f"bweuler_path: residual {resid} > 1e-10")


def phase_dense_factor():
    """Radau5 with default Params on the npoint-24 Brusselator (ndim 1,152,
    AUTO → DENSE with the grid hint) on the card and on the CPU in this run
    (counters exact, y at rtol 1e-10); then one factorize pair at the
    replay's shifts on both devices: residuals <= 1e-12 on the card,
    log|det|, min|pivot| and sign (phase) at rtol 1e-12 of the CPU's, and
    the pair's and a solve pair's device times."""
    from russell_tpu_torch.ode import Method, OdeSolver, Params, samples
    from russell_tpu_torch.sparse import factor
    from russell_tpu_torch.sparse.enums import Genie
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT_DENSE)
    res = {}
    for dev in ("cuda", "cpu"):
        sol = OdeSolver(Params(Method.RADAU5), system, dev)
        if sol.actual.plan.genie != Genie.DENSE:
            raise AssertionError(f"npoint {NPOINT_DENSE}: AUTO picked "
                                 f"{sol.actual.plan.genie}")
        t_start = time.perf_counter()
        y = sol.solve(y0, t0, 1.0)
        if dev == "cuda":
            torch.cuda.synchronize()
        res[dev] = (time.perf_counter() - t_start, counters(sol.stats()),
                    y.cpu(), sol)
    (wall, got, y, sol), (cwall, cgot, cy, csol) = res["cuda"], res["cpu"]
    rec = {"npoint": NPOINT_DENSE, "ndim": system.ndim, "wall_s": wall,
           "cpu_wall_s": cwall, "counters": got,
           "y_max_rel_err_vs_cpu": float(((y - cy).abs() / cy.abs()).max())}
    if got != cgot:
        say("dense_factor", **rec, cpu_counters=cgot)
        raise AssertionError(f"dense_factor: counters {got} != CPU {cgot}")
    torch.testing.assert_close(y, cy, rtol=1e-10, atol=0)
    # one factorize pair at y0 with the replay's h
    jv = torch.as_tensor(system.jacobian(t0, torch.as_tensor(y0), None)
                         .numpy())
    facs = {}
    for dev, s in (("cuda", sol), ("cpu", csol)):
        facs[dev] = s.actual._factorize(jv.to(dev), H_REPLAY)
    plan = sol.actual.plan
    fr, fc = facs["cuda"]
    g = torch.Generator().manual_seed(SEED)
    br = torch.randn(system.ndim, generator=g, dtype=torch.float64)
    bc = torch.complex(torch.randn(system.ndim, generator=g,
                                   dtype=torch.float64),
                       torch.randn(system.ndim, generator=g,
                                   dtype=torch.float64))
    brd, bcd = br.cuda(), bc.cuda()
    xr, xc = factor.factor_solve_pair(plan, fr, fc, brd, bcd, refine_steps=0)
    stats = {}
    for kind, f, cf, x, b in (("real", fr, facs["cpu"][0], xr, brd),
                              ("complex", fc, facs["cpu"][1], xc, bcd)):
        r = factor._residual(plan, f, x, b)
        stats[kind] = {"residual": float(r.abs().max() / b.abs().max())}
        for k in ("logdet", "min_pivot", "phase"):
            got_v, want_v = f[k].cpu(), cf[k]
            stats[kind][k] = ([float(got_v.real), float(got_v.imag)]
                              if got_v.is_complex() else float(got_v))
            torch.testing.assert_close(got_v, want_v, rtol=1e-12, atol=0,
                                       msg=lambda m: f"dense {kind} {k}: {m}")
        if not stats[kind]["residual"] <= 1e-12:
            raise AssertionError(f"dense_factor: {kind} residual "
                                 f"{stats[kind]['residual']} > 1e-12")
    # per call, CUDA events around each: the host's launches included
    jvd = jv.cuda()
    rec.update(
        pair=stats, factorize_pair_ms=call_ms(
            lambda: sol.actual._factorize(jvd, H_REPLAY), reps=10),
        solve_pair_ms=call_ms(lambda: factor.factor_solve_pair(
            plan, fr, fc, brd, bcd, refine_steps=0), reps=10))
    say("dense_factor", **rec)


# ---------------------------------------------------------------------------
# fused_path: the whole integration on the card (solve(fused=True),
# solve_batch), a step attempt captured as one CUDA graph
# ---------------------------------------------------------------------------

FUSED_WARM_RUNS = 2
FUSED_BATCH = 64


def fused_kernel_counts():
    from russell_tpu_torch.ode import _lanes
    from russell_tpu_torch.sparse import splu
    return {"splu_pairs": splu.splu_pairs.launches,
            "gather_rows": splu.gather_rows.launches,
            "gj_inv": splu._gj_inv.launches,
            "lane_pow": _lanes.lane_pow.launches}


def loop_record(fn):
    """The captured graph of a fused solver ``fn`` and its last run."""
    lp = fn.loop
    return {"nodes_per_attempt": lp.nodes, "if_nodes": lp.if_nodes,
            "body_nodes": {str(k): v for k, v in lp.body_nodes.items()},
            "replays": lp.replays, "flag_reads": lp.reads,
            "replays_per_read": lp.replays // max(lp.reads, 1),
            "warmup_s": lp.warmup_s, "capture_instantiate_s": lp.capture_s}


def fused_runs(params, system, y0, t0, x1, warm_runs, output=None):
    """A cold fused run (a fresh solver: host analysis, uploads, warm-up,
    capture and instantiation, replays), then ``warm_runs`` more solves on
    the same solver, which replay the captured graph. The kernel counts
    start at 0 before the cold run: the warm-up's launches and the
    capture's nodes. Returns (record, solver, y of the last run)."""
    from russell_tpu_torch.ode import OdeSolver
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    sol = OdeSolver(params, system, "cuda")
    y = sol.solve(y0, t0, x1, fused=True, output=output)
    torch.cuda.synchronize()
    rec = {"cold_wall_s": time.perf_counter() - t,
           "launches_cold_run": fused_kernel_counts(),
           "peak_mem_bytes_cold": torch.cuda.max_memory_allocated()}
    fn = next(iter(sol._fused.values()))
    rec.update(loop_record(fn))
    warm = []
    for _ in range(warm_runs):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        y = sol.solve(y0, t0, x1, fused=True, output=output)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t)
    if warm:
        rec.update(warm_walls_s=warm, warm_median_s=statistics.median(warm),
                   warm_spread_s=max(warm) - min(warm),
                   peak_mem_bytes_warm=torch.cuda.max_memory_allocated(),
                   replays=fn.loop.replays, flag_reads=fn.loop.reads)
    rec["counters"] = counters(sol.stats())
    return rec, sol, y


def captured_nodes(sol, y0, t0, x1):
    """Each kernel's nodes in one captured step attempt: a fresh fused
    solver of ``sol``'s, warmed up, its counts reset, then captured."""
    fn = sol._build_fused(1)
    h0 = min(sol.params.step.h_ini, x1 - t0)
    fn.start(t0, torch.as_tensor(np.asarray(y0), device="cuda")[None], x1,
             h0)
    fn.loop.warm_up()
    reset_launch_counts()
    fn.loop.capture(warm_up=False)
    return fused_kernel_counts(), fn


LANE_POW_EXPONENTS = (0.17, 0.04, 0.25, 0.8, 3.0, -0.2)


def phase_lane_pow():
    """The fused controllers' pow (``csrc/lane_pow.cu``) against its plain
    version (the C library's pow, which the host path's Python floats
    use) on 10,000 bases per exponent of the controllers' kinds, beside
    CUDA's own pow; then its time at the fused path's shape (one lane) and
    at 64 lanes. Returns the kernels-line entry."""
    from russell_tpu_torch.ode import _lanes
    rng = np.random.default_rng(SEED)
    v = np.concatenate([rng.uniform(1e-3, 2.0, 5000),
                        10.0 ** rng.uniform(-10.0, 1.0, 5000)])
    t = torch.as_tensor(v, device="cuda")
    rows, worst = [], 0.0
    for e in LANE_POW_EXPONENTS:
        want = _lanes.lane_pow(torch.as_tensor(v), e).numpy()
        got = _lanes.lane_pow(t, e).cpu().numpy()
        cuda_pow = torch.pow(t, torch.full_like(t, e)).cpu().numpy()
        rel = float((np.abs(got - want) / np.abs(want)).max())
        worst = max(worst, float(np.abs(got - want).max()))
        rows.append({"e": e, "kernel_mismatches": int((got != want).sum()),
                     "cuda_pow_mismatches": int((cuda_pow != want).sum()),
                     "kernel_max_rel_err": rel})
    one = t[:1].clone()
    lanes = t[:FUSED_BATCH].clone()
    rec = {"name": "lane_pow", "route": "cuda",
           "source": "russell_tpu_torch/csrc/lane_pow.cu",
           "replaces": "russell_tpu/ode/radau5_fused.py:418 (plain XLA "
                       "pow of the fused controllers, no Pallas kernel; "
                       "also erk_fused.py:210)",
           "max_abs_err": worst,
           "ms": time_ms(lambda: _lanes.lane_pow(one, 0.25)),
           "ms_64_lanes": time_ms(lambda: _lanes.lane_pow(lanes, 0.25)),
           "plain_ms": time_ms(lambda: _lanes._lane_pow_plain(one, 0.25)),
           "library_ms": time_ms(lambda: torch.pow(one, 0.25))}
    # one value read and one written; ~600 f64 operations of the
    # double-double log and exp
    rec["bound_ms"], rec["bound_by"] = bound(16, 600)
    say("fused_path", part="lane_pow", values=len(v), exponents=rows,
        **{k: rec[k] for k in ("ms", "ms_64_lanes", "plain_ms",
                               "library_ms", "bound_ms")})
    for r in rows:
        if r["kernel_mismatches"] > len(v) // 500 or not r[
                "kernel_max_rel_err"] <= 2.3e-16:
            raise AssertionError(f"lane_pow: {r} (more than 0.2 % of the "
                                 "values off the C library's pow, or more "
                                 "than an ulp)")
    return rec


def check_counters(name, got, want):
    if got != want:
        raise AssertionError(f"fused_path {name}: counters {got} != the "
                             f"host-stepped run's {want}")


def fused_entry(fres, name):
    """A kernel's nodes per captured step attempt and its launches in the
    cold fused runs (warm-up launches plus capture nodes) of phase
    fused_path; the BSR kernels are on no fused path."""
    out = {}
    for part in ("gridmf_129", "splu_129", "gridmf_513", "batch_gridmf_129",
                 "batch_splu_129", f"genmf_{NPOINT_GENIES}",
                 f"banded_{NPOINT_GENIES}"):
        rec = fres.get(part, {})
        if "nodes_per_kernel" in rec:
            out[f"{part}_nodes_per_attempt"] = rec["nodes_per_kernel"].get(
                name, 0)
        if "launches_cold_run" in rec:
            out[f"{part}_launches_cold_run"] = rec[
                "launches_cold_run"].get(name, 0)
        if "replays" in rec:
            out[f"{part}_replays"] = rec["replays"]
    return out


def batch_entry(fres, name):
    """A batched kernel's numbers from fused_path's batches: its nodes per
    captured step attempt at SPARSE_BATCH lanes and at one, per batch, and
    its check and times at the lanes' shapes (``batch_kernel_checks``)."""
    out = {"nodes_per_attempt": {
        part: {"lanes": fres[part]["nodes_per_kernel"].get(name, 0),
               "one_lane": fres[part]["single_nodes_per_kernel"].get(name, 0)}
        for part in ("batch_gridmf_129", "batch_splu_129",
                     f"genmf_{NPOINT_GENIES}", f"banded_{NPOINT_GENIES}")
        if part in fres}}
    out.update(fres.get("batch_kernels", {}).get(name, {}))
    return out


def phase_fused_path(gridmf_host, splu_host, erk_host):
    """The fused whole-integration loops on the card: radau5.f's oracles
    through DENSE, the bench.py configuration (GRIDMF at npoint 129) cold
    and warm with its graph, nodes, flag reads and device busy share,
    replay-count invariance, SPLU at 129, GRIDMF at 513, DoPri5 at 513 and
    DoPri8 with dense stations at 129, and solve_batch; each held to the
    host-stepped run of the same configuration in this smoke."""
    from russell_tpu_torch.ode import (Method, Output, Params, _device_loop,
                                       samples)
    from russell_tpu_torch.sparse.enums import Genie
    res = {"lane_pow": phase_lane_pow()}
    gc.collect()
    torch.cuda.empty_cache()

    # radau5.f oracles through DENSE (tests/test_ode.py:236, :384)
    system, x0, y0, x1, _ = samples.van_der_pol(1e-6, False)
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    rec, sol, y = fused_runs(params, system, y0, x0, x1, 0)
    y = y.cpu().numpy()
    want = {"n_function": 2249, "n_jacobian": 162, "n_factor": 253,
            "n_lin_sol": 668, "n_steps": 280, "n_accepted": 242,
            "n_rejected": 8, "n_iterations_max": 6}
    got = {k: rec["counters"][k] for k in want}
    say("fused_path", part="availability", torch=torch.__version__,
        cuda=torch.version.cuda,
        conditional_nodes_captured=rec["if_nodes"] > 0,
        replays_per_read=_device_loop.REPLAYS_PER_READ)
    say("fused_path", part="van_der_pol_dense",
        genie=sol.actual.plan.genie.name, y=y.tolist(), **rec)
    if (got != want or abs(y[0] - 1.706163410178079) >= 1e-12
            or abs(y[1] + 0.8927971289301175) >= 1e-11
            or sol.actual.plan.genie != Genie.DENSE or rec["if_nodes"] <= 0):
        raise AssertionError(f"fused van der Pol: {got} != radau5.f {want}"
                             " (or y off the oracle, or not DENSE)")
    system, x0, y0, _ = samples.robertson()
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    params.set_tolerances(1e-8, 1e-2)
    rec, sol, y = fused_runs(params, system, y0, x0, 0.3, 0)
    y = y.cpu().numpy()
    want = {"n_function": 88, "n_jacobian": 8, "n_factor": 15,
            "n_lin_sol": 24, "n_steps": 17, "n_accepted": 15,
            "n_rejected": 1}
    got = {k: rec["counters"][k] for k in want}
    say("fused_path", part="robertson_dense", y=y.tolist(), **rec)
    if got != want or any(abs(a - b) >= 1e-15 for a, b in zip(y, (
            9.886740138499884e-01, 3.447720471782070e-05,
            1.129150894529390e-02))):
        raise AssertionError(f"fused Robertson: {got} != radau5.f {want} "
                             "(or y off the oracle)")

    # the bench.py configuration: default Params (AUTO -> GRIDMF), npoint
    # 129, tolerances 1e-4, t 0 -> 1
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT)
    params = Params(Method.RADAU5)
    params.set_tolerances(1e-4, 1e-4)
    rec, sol, y = fused_runs(params, system, y0, t0, 1.0, FUSED_WARM_RUNS)
    check_counters("gridmf_129", rec["counters"], gridmf_host["counters"])
    y_err = float((y.cpu() - gridmf_host["y"]).abs().max())
    if not y_err <= 1e-12 or sol.actual.plan.genie != Genie.GRIDMF:
        raise AssertionError(f"fused GRIDMF 129: y off the host-stepped "
                             f"run's by {y_err} (atol 1e-12), or not GRIDMF")
    if rec["launches_cold_run"]["gj_inv"] <= 0:
        raise AssertionError("fused GRIDMF 129: gj_inv was not launched")
    ms, p_wall, events = kernel_device_ms(
        lambda: sol.solve(y0, t0, 1.0, fused=True))
    rec.update(device_ms=sum(ms.values()), device_events=events,
               profiled_wall_s=p_wall,
               device_busy_share=sum(ms.values()) / 1e3 / rec[
                   "warm_median_s"],
               gj_inv_device_ms=summed(ms, "gj_inv"),
               host_stepped_warm_median_s=gridmf_host["warm_median_s"],
               host_stepped_counters=gridmf_host["counters"],
               y_max_abs_err_vs_host=y_err)
    y8 = y.clone()
    c8 = counters(sol.stats())
    # replay-count invariance: one replay per flag read gives the same bits
    nodes, fn = captured_nodes(sol, y0, t0, 1.0)
    default = _device_loop.REPLAYS_PER_READ
    try:
        _device_loop.REPLAYS_PER_READ = 1
        fn.loop.run()
    finally:
        _device_loop.REPLAYS_PER_READ = default
    y1, st1 = fn.result()
    c1 = {k: int(st1[k][0]) if k in st1 else c8[k] for k in c8}
    same = bool(torch.equal(y1[0], y8)) and c1 == c8
    rec.update(nodes_per_kernel=nodes, replay_invariance={
        "replays_per_read": 1, "reads": fn.loop.reads,
        "bit_identical": same})
    say("fused_path", part="gridmf_129", npoint=NPOINT, **rec)
    if not same:
        raise AssertionError("fused GRIDMF 129: one replay per flag read "
                             "changes y or the counters")
    res["gridmf_129"] = rec
    del sol, fn, y, y1, y8
    gc.collect()
    torch.cuda.empty_cache()

    # SPLU at npoint 129
    params = Params(Method.RADAU5)
    params.set_tolerances(1e-4, 1e-4)
    params.newton.genie = Genie.SPLU
    rec, sol, y = fused_runs(params, system, y0, t0, 1.0, 1)
    check_counters("splu_129", rec["counters"], splu_host["counters"])
    y_err = float((y.cpu() - splu_host["y"]).abs().max())
    nodes, fn = captured_nodes(sol, y0, t0, 1.0)
    rec.update(nodes_per_kernel=nodes, y_max_abs_err_vs_host=y_err,
               host_stepped_warm_wall_s=splu_host["wall_s"])
    say("fused_path", part="splu_129", npoint=NPOINT, **rec)
    if not y_err == 0.0:
        raise AssertionError(f"fused SPLU 129: y off the host-stepped run's"
                             f" by {y_err} (the ordered sums give the same "
                             "bits)")
    for k in ("splu_pairs", "gather_rows", "gj_inv"):
        if rec["launches_cold_run"][k] <= 0 or nodes[k] <= 0:
            raise AssertionError(f"fused SPLU 129: {k} was not launched")
    res["splu_129"] = rec
    del sol, fn, y
    gc.collect()
    torch.cuda.empty_cache()

    # GRIDMF at npoint 513 (bench.py's top rung): host-stepped, then fused
    from russell_tpu_torch.ode import OdeSolver
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT_BSR)
    params = Params(Method.RADAU5)
    params.set_tolerances(1e-4, 1e-4)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    host = OdeSolver(params, system, "cuda")
    yh = host.solve(y0, t0, 1.0)
    torch.cuda.synchronize()
    host_rec = {"wall_s": time.perf_counter() - t,
                "counters": counters(host.stats()),
                "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    yh = yh.cpu()
    del host
    gc.collect()
    torch.cuda.empty_cache()
    rec, sol, y = fused_runs(params, system, y0, t0, 1.0, 1)
    check_counters("gridmf_513", rec["counters"], host_rec["counters"])
    y_err = float((y.cpu() - yh).abs().max())
    gplan = sol.actual.plan.gridmf_plan
    rec.update(host_stepped=host_rec, y_max_abs_err_vs_host=y_err,
               depths=len(gplan.levels), leaf_front_e=gplan.levels[-1].e)
    say("fused_path", part="gridmf_513", npoint=NPOINT_BSR, **rec)
    if not y_err <= 1e-10:
        raise AssertionError(f"fused GRIDMF 513: y off the host-stepped "
                             f"run's by {y_err} (atol 1e-10)")
    res["gridmf_513"] = rec
    del sol, y, yh
    gc.collect()
    torch.cuda.empty_cache()

    # DoPri5 at npoint 513 against erk_path's host-stepped run (its
    # stiffness detection changes no step), with the same dense stations
    params = Params(Method.DOPRI5)
    params.set_tolerances(1e-4, 1e-4)
    stations = []

    def keep(stats, h, x, yy, args):
        stations.append(x)
        return False

    out = Output().set_dense_h_out(0.1).set_dense_callback(keep)
    rec, sol, y = fused_runs(params, system, y0, t0, 1.0, 1, output=out)
    host = erk_host[("DOPRI5", NPOINT_BSR)]
    check_counters("dopri5_513", rec["counters"], host["counters"])
    y_err = float(((y.cpu() - host["y"]).abs() / host["y"].abs()).max())
    win = sol.solve(y0, t0, ERK_WINDOW_X1, fused=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    sol.solve(y0, t0, ERK_WINDOW_X1, fused=True)
    torch.cuda.synchronize()
    w_wall = time.perf_counter() - t
    w_steps = sol.stats().n_steps
    ms, p_wall, events = kernel_device_ms(
        lambda: sol.solve(y0, t0, ERK_WINDOW_X1, fused=True))
    rec.update(y_max_rel_err_vs_host=y_err, host_stepped_wall_s=host[
        "wall_s"], stations=len(out.dense_x()), window={
            "x1": ERK_WINDOW_X1, "steps": w_steps, "wall_s": w_wall,
            "device_ms": sum(ms.values()), "device_events": events,
            "profiled_wall_s": p_wall,
            "device_busy_share": sum(ms.values()) / 1e3 / w_wall})
    say("fused_path", part="dopri5_513", npoint=NPOINT_BSR, **rec)
    if not y_err <= 1e-10:
        raise AssertionError(f"fused DoPri5 513: y off the host-stepped "
                             f"run's by {y_err} (rtol 1e-10)")
    res["dopri5_513"] = rec
    del sol, y, win
    gc.collect()
    torch.cuda.empty_cache()

    # DoPri8 at npoint 129 with dense stations every 0.1, held to a
    # host-stepped run of the same parameters
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT)
    params = Params(Method.DOPRI8)
    params.set_tolerances(1e-4, 1e-4)
    outs = {}
    for fused in (False, True):
        o = Output().set_dense_h_out(0.1).set_dense_recording(
            list(range(0, system.ndim, 997)))
        s8 = OdeSolver(params, system, "cuda")
        t = time.perf_counter()
        s8.solve(y0, t0, 1.0, output=o, fused=fused)
        torch.cuda.synchronize()
        outs[fused] = (o, time.perf_counter() - t, counters(s8.stats()))
    err = max(float(np.abs(np.asarray(outs[True][0].dense_y(m))
                           - np.asarray(outs[False][0].dense_y(m))).max())
              for m in range(0, system.ndim, 997))
    say("fused_path", part="dopri8_129_dense", npoint=NPOINT,
        stations=len(outs[True][0].dense_x()), station_max_abs_err=err,
        fused_cold_wall_s=outs[True][1], host_wall_s=outs[False][1],
        counters=outs[True][2])
    check_counters("dopri8_129", outs[True][2], outs[False][2])
    if not err <= 1e-10 or outs[True][0].dense_x() != outs[False][
            0].dense_x():
        raise AssertionError(f"fused DoPri8 129: stations off the host's by"
                             f" {err} (atol 1e-10)")

    # solve_batch: each lane held to its single fused solve
    for name, make in (("van_der_pol", "RADAU5"), ("hairer_wanner", "DOPRI5")):
        if name == "van_der_pol":
            system, x0, y0, _, _ = samples.van_der_pol(1e-4, False)
            y0s = np.tile(np.asarray(y0)[None, :], (FUSED_BATCH, 1))
            y0s[:, 0] += np.linspace(-0.2, 0.2, FUSED_BATCH)
            x1, params = 1.0, Params(Method.RADAU5)
        else:
            system, x0, y0, _, _ = samples.hairer_wanner_eq1()
            y0s = np.linspace(0.5, 2.0, FUSED_BATCH)[:, None] * np.asarray(
                y0)[None, :]
            y0s[:, 0] += np.linspace(0.0, 0.7, FUSED_BATCH)
            x1, params = 1.5, Params(Method.DOPRI5)
            params.step.h_ini = 1e-4
        bsol = OdeSolver(params, system, "cuda")
        walls = []
        for _ in range(2):
            t = time.perf_counter()
            ys, st = bsol.solve_batch(y0s, x0, x1)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        keys = [k for k in counters(bsol.stats()) if k in st]
        worst, bad = 0.0, []
        t = time.perf_counter()
        for b in range(FUSED_BATCH):
            yb = bsol.solve(y0s[b], x0, x1, fused=True)
            worst = max(worst, float((yb - ys[b]).abs().max()))
            single = counters(bsol.stats())
            if any(int(st[k][b]) != single[k] for k in keys):
                bad.append(b)
        torch.cuda.synchronize()
        singles = time.perf_counter() - t
        say("fused_path", part=f"solve_batch_{name}", method=make,
            lanes=FUSED_BATCH, cold_wall_s=walls[0], warm_wall_s=walls[1],
            singles_wall_s=singles, statuses=sorted(set(
                st["status"].tolist())),
            n_accepted_range=[int(st["n_accepted"].min()),
                              int(st["n_accepted"].max())],
            lane_max_abs_err=worst, lanes_with_other_counters=bad,
            genie=(bsol.actual.plan.genie.name if make == "RADAU5"
                   else None))
        if (st["status"].tolist() != [1] * FUSED_BATCH or bad
                or not worst <= 1e-12):
            raise AssertionError(f"solve_batch {name}: lanes {bad} differ "
                                 f"from single solves (y by {worst})")
    del bsol, ys, st
    gc.collect()
    torch.cuda.empty_cache()
    res.update(fused_batch_path(res))
    return res


# -- fused_path, batches through the sparse genies ---------------------------

# lanes of solve_batch through the sparse genies (one batched numeric phase
# over one plan), and the wider batch tried for GRIDMF at npoint 129
SPARSE_BATCH = 8
SPARSE_BATCH_WIDE = 16
# GENMF and BANDED by name (AUTO gives GRIDMF with the grid hint), over
# t 0 -> X1_GENIES (half bench.py's span: the smoke's time limit)
NPOINT_GENIES = 65
X1_GENIES = 0.5
# the kernels batched: their nodes per captured step attempt must not grow
# with the lanes
BATCHED_KERNELS = ("splu_pairs", "gather_rows", "gj_inv")


def spread_lanes(y0, lanes):
    """``lanes`` initial states of the Brusselator: y0 scaled by 1 to 1.5,
    which takes the lanes through different step counts."""
    y0 = np.asarray(y0)
    return y0[None] * (1.0 + 0.5 * np.arange(lanes) / (lanes - 1))[:, None]


def captured_run(sol, y0s, t0, x1):
    """A fused solve of the lanes ``y0s`` (B, ndim) on ``sol``'s fused
    solver of B lanes, run as ``solve_batch`` runs it (``solve`` for one
    lane), but with the kernel counts reset between the warm-up and the
    capture. Returns (y (B, ndim), stats, each kernel's nodes per captured
    step attempt, the wall of the whole: set-up, warm-up, capture,
    replays; and of the set-up alone: ``start``, which uploads the plan
    and, for several lanes, factors the kept pair eagerly)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    y0t = torch.as_tensor(np.asarray(y0s), dtype=torch.float64,
                          device="cuda")
    fn = sol._fused_for(y0t.shape[0])
    fn.start(t0, y0t, x1, min(sol.params.step.h_ini, x1 - t0))
    torch.cuda.synchronize()
    start_s = time.perf_counter() - t
    fn.loop.warm_up()
    reset_launch_counts()
    fn.loop.capture(warm_up=False)
    nodes = fused_kernel_counts()
    fn.loop.run()
    y, st = fn.result()
    torch.cuda.synchronize()
    return y, st, nodes, time.perf_counter() - t, start_s


def batch_vs_singles(name, params, system, t0, y0s, x1):
    """``solve_batch`` of the lanes ``y0s`` on a fresh solver: cold (plan,
    warm-up, capture, replays; the kernels' nodes per captured attempt)
    and warm, with peak memory; then a single fused solve of lane 0
    captured the same way (nodes at one lane) and the B single fused
    solves, timed warm, each lane of the batch held to its single solve
    (counters equal, y at atol 1e-12). Raises where a lane differs, where
    all lanes take the same step count, or where a kernel's nodes per
    attempt grow with the lanes. Returns (record, solver)."""
    from russell_tpu_torch.ode import OdeSolver
    B = len(y0s)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    sol = OdeSolver(params, system, "cuda")
    setup_s = time.perf_counter() - t
    ys, st, nodes, cold, start_s = captured_run(sol, y0s, t0, x1)
    cold += setup_s
    peak_cold = torch.cuda.max_memory_allocated()
    fn = sol._fused_for(B)
    rec = {"lanes": B, "genie": sol.actual.plan.genie.name,
           "cold_wall_s": cold, "start_s": start_s,
           "warmup_s": fn.loop.warmup_s,
           "capture_instantiate_s": fn.loop.capture_s,
           "nodes_per_attempt": fn.loop.nodes, "nodes_per_kernel": nodes,
           "peak_mem_bytes_cold": peak_cold}
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    ys2, st2 = sol.solve_batch(y0s, t0, x1)
    torch.cuda.synchronize()
    rec.update(warm_wall_s=time.perf_counter() - t,
               peak_mem_bytes_warm=torch.cuda.max_memory_allocated(),
               replays=fn.loop.replays, flag_reads=fn.loop.reads,
               warm_bit_identical=bool(torch.equal(ys, ys2)))
    _, _, nodes1, cold1, _ = captured_run(sol, y0s[:1], t0, x1)
    singles, walls = [], []
    for b in range(B):
        t = time.perf_counter()
        yb = sol.solve(y0s[b], t0, x1, fused=True)
        walls.append(time.perf_counter() - t)
        singles.append((yb, counters(sol.stats())))
    keys = [k for k in singles[0][1] if k in st]
    worst = max(float((yb - ys[b]).abs().max())
                for b, (yb, _) in enumerate(singles))
    bad = [b for b, (_, c) in enumerate(singles)
           if any(int(st[k][b]) != c[k] for k in keys)]
    n_acc = st["n_accepted"].tolist()
    rec.update(single_cold_wall_s=cold1, single_nodes_per_kernel=nodes1,
               single_nodes_per_attempt=sol._fused_for(1).loop.nodes,
               singles_wall_s=sum(walls), single_walls_s=walls,
               warm_over_singles=rec["warm_wall_s"] / sum(walls),
               n_accepted=n_acc, statuses=st["status"].tolist(),
               lane_max_abs_err=worst, lanes_with_other_counters=bad)
    say("fused_path", part=f"batch_{name}", **rec)
    if (st["status"].tolist() != [1] * B or bad or not worst <= 1e-12
            or not rec["warm_bit_identical"]):
        raise AssertionError(f"solve_batch {name}: lanes {bad} differ from "
                             f"single fused solves (y by {worst}), or a "
                             "lane did not finish, or the warm run differs")
    if len(set(n_acc)) < 2:
        raise AssertionError(f"solve_batch {name}: every lane took "
                             f"{n_acc[0]} steps")
    for k in BATCHED_KERNELS:
        if nodes[k] != nodes1[k]:
            raise AssertionError(f"solve_batch {name}: {k} has {nodes[k]} "
                                 f"nodes a step attempt at {B} lanes and "
                                 f"{nodes1[k]} at one")
    return rec, sol


def host_vs_fused(name, params, system, t0, y0, x1):
    """A host-stepped solve and a single fused solve of one configuration:
    counters equal and y bit for bit. Returns the record."""
    from russell_tpu_torch.ode import OdeSolver
    t = time.perf_counter()
    host = OdeSolver(params, system, "cuda")
    analyze_s = time.perf_counter() - t
    yh = host.solve(y0, t0, x1)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    hc = counters(host.stats())
    genie = host.actual.plan.genie.name
    del host
    gc.collect()
    torch.cuda.empty_cache()
    rec, sol, yf = fused_runs(params, system, y0, t0, x1, 1)
    rec.update(genie=genie, host_stepped_wall_s=host_s,
               host_analyze_s=analyze_s, host_counters=hc,
               y_bit_identical=bool(torch.equal(yf, yh)),
               y_max_abs_err_vs_host=float((yf - yh).abs().max()))
    say("fused_path", part=f"single_{name}", **rec)
    check_counters(name, rec["counters"], hc)
    if not rec["y_bit_identical"]:
        raise AssertionError(f"fused {name}: y differs from the host-stepped"
                             f" run's by {rec['y_max_abs_err_vs_host']}")
    return rec


def fused_batch_path(res):
    """``solve_batch`` through the sparse genies, one batched numeric phase
    over one plan: AUTO -> GRIDMF and SPLU at npoint 129 (the bench.py
    configuration) with SPARSE_BATCH lanes, then GRIDMF at
    SPARSE_BATCH_WIDE lanes where it fits (walls and peak only, or the
    refusal, with what the capture's memory check read); GENMF and BANDED
    by name at NPOINT_GENIES, first one lane fused against the
    host-stepped run (counters, y bit for bit), then
    SPARSE_BATCH lanes. Each batch's lanes are held to single fused solves
    (``batch_vs_singles``), and its kernels' nodes per captured attempt to
    one lane's. Then each batched kernel at these lanes' shapes
    (``batch_kernel_checks``). Returns the records."""
    from russell_tpu_torch.ode import Method, Params, samples
    from russell_tpu_torch.sparse.enums import Genie
    out = {}
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT)
    y0s = spread_lanes(y0, SPARSE_BATCH)
    params = Params(Method.RADAU5)
    params.set_tolerances(1e-4, 1e-4)
    rec, sol = batch_vs_singles("gridmf_129", params, system, t0, y0s, 1.0)
    if rec["genie"] != "GRIDMF":
        raise AssertionError(f"AUTO picked {rec['genie']} at npoint 129")
    gplan = sol.actual.plan.gridmf_plan
    out["batch_gridmf_129"] = rec
    del sol
    gc.collect()
    torch.cuda.empty_cache()
    # the wider batch: solve_batch refuses it before its capture where the
    # warm-up's reservation does not fit on the card (a capture that runs
    # out of memory inside a conditional body cannot be ended cleanly);
    # the refusal is the reason recorded
    from russell_tpu_torch.ode import OdeSolver
    ysw = spread_lanes(y0, SPARSE_BATCH_WIDE)
    wide = {"lanes": SPARSE_BATCH_WIDE,
            "device_bytes": torch.cuda.get_device_properties(0).total_memory}
    torch.cuda.reset_peak_memory_stats()
    wsol = OdeSolver(params, system, "cuda")
    t = time.perf_counter()
    try:
        _, stw = wsol.solve_batch(ysw, t0, 1.0)
    except ValueError as e:
        wide["skipped"] = str(e)
    loop = wsol._fused_for(SPARSE_BATCH_WIDE).loop
    wide.update(warmup_bytes=loop.warmup_bytes,
                warmup_retries=loop.warmup_retries,
                capture_free_bytes=loop.capture_free)
    if "skipped" not in wide:
        torch.cuda.synchronize()
        wide["cold_wall_s"] = time.perf_counter() - t
        wide["peak_mem_bytes_cold"] = torch.cuda.max_memory_allocated()
        t = time.perf_counter()
        _, stw = wsol.solve_batch(ysw, t0, 1.0)
        torch.cuda.synchronize()
        wide["warm_wall_s"] = time.perf_counter() - t
        wide["statuses"] = sorted(set(stw["status"].tolist()))
        wide["n_accepted"] = stw["n_accepted"].tolist()
        if wide["statuses"] != [1]:
            raise AssertionError(f"solve_batch gridmf_129 x "
                                 f"{SPARSE_BATCH_WIDE}: {wide['statuses']}")
    del wsol, loop
    say("fused_path", part=f"batch_gridmf_129_x{SPARSE_BATCH_WIDE}", **wide)
    out["batch_gridmf_129"]["wide"] = wide
    gc.collect()
    torch.cuda.empty_cache()

    params = Params(Method.RADAU5)
    params.set_tolerances(1e-4, 1e-4)
    params.newton.genie = Genie.SPLU
    rec, sol = batch_vs_singles("splu_129", params, system, t0, y0s, 1.0)
    splan = sol.actual.plan
    out["batch_splu_129"] = rec
    del sol
    gc.collect()
    torch.cuda.empty_cache()

    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT_GENIES)
    for genie in (Genie.GENMF, Genie.BANDED):
        name = f"{genie.name.lower()}_{NPOINT_GENIES}"
        params = Params(Method.RADAU5)
        params.set_tolerances(1e-4, 1e-4)
        params.newton.genie = genie
        single = host_vs_fused(name, params, system, t0, y0, X1_GENIES)
        gc.collect()
        torch.cuda.empty_cache()
        rec, sol = batch_vs_singles(name, params, system, t0,
                                    spread_lanes(y0, SPARSE_BATCH),
                                    X1_GENIES)
        rec["single"] = single
        if genie == Genie.BANDED:
            rec["bcr"] = sol.actual.plan.use_bcr
            rec["block_k"] = sol.actual.plan.block_k
        out[name] = rec
        del sol
        gc.collect()
        torch.cuda.empty_cache()
    out["batch_kernels"] = batch_kernel_checks(splan, gplan)
    return out


def batch_kernel_checks(splan, gplan):
    """Each batched kernel on the card at the lane shapes of the npoint-129
    SPARSE_BATCH-lane runs: ``splu_pairs`` and ``gather_rows`` over every
    row of the SPLU plan with (B, N, be^2) blocks, be b and 2b, and
    ``gj_inv`` at every base shape of a GRIDMF factorize pair with B
    matrices' lanes and a pivot threshold per matrix (zero pivots to clamp,
    and a small one only its matrix's threshold catches). Each is held to
    its plain version (splu_pairs at rtol 1e-12 as phase 4; gather_rows
    and gj_inv's Dinv bit for bit, log|det| at rtol 1e-14 as phase 11,
    n_perturbed exact per lane) and bit for bit to B single-lane launches
    of the same kernel on the same inputs. Timed (``time_ms``) at phase
    4's rows and over the GRIDMF pair's base calls: the batched launch
    against the B single-lane launches, beside the bound of the batched
    work (each lane's distinct bytes once over 3.35 TB/s, or its flops),
    and gather_rows beside ``index_select`` on the same blocks. Returns the
    kernels line's numbers."""
    from russell_tpu_torch.sparse import splu
    B = SPARSE_BATCH
    sp = splan.splu_plan
    dev = torch.device("cuda")
    dp = splu._device_plan(sp, dev)
    pk = sp.packed
    named, _ = named_rows(sp, dp)
    # drawn on the card: the host's draws of these (B, n_store, be^2)
    # blocks were among the smoke's costliest host steps
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    n_store = sp.nblk + pk["TL"] + 1
    out = {"splu_pairs": {"ms": 0.0, "singles_ms": 0.0, "bound_ms": 0.0,
                          "plain_ms": 0.0, "library_ms": None,
                          "max_abs_err": 0.0},
           "gather_rows": {"ms": 0.0, "singles_ms": 0.0, "bound_ms": 0.0,
                           "plain_ms": 0.0, "max_abs_err": 0.0}}
    for be in (sp.b, 2 * sp.b):
        blocks = torch.randn((B, n_store, be * be), generator=gen,
                             dtype=torch.float64, device=dev)

        def row_args(r):
            _, ln, _, npair, *_ = dp["rows"][r]
            return (dp["pair_l"][r, :npair], dp["pair_u"][r, :npair],
                    dp["pair_seg"][r, :npair], dp["work"][r], ln, be)

        for r in range(len(dp["rows"])):
            args = row_args(r)
            got = splu.splu_pairs(blocks, *args)
            idx = dp["dinv"][r, :args[4]]
            rows = splu.gather_rows(blocks, idx)
            for lane in range(B):
                if not torch.equal(got[lane],
                                   splu.splu_pairs(blocks[lane], *args)):
                    raise AssertionError(f"splu_pairs row {r} be {be} lane "
                                         f"{lane}: the batched launch "
                                         "differs from a one-lane launch")
                if not torch.equal(rows[lane],
                                   splu.gather_rows(blocks[lane], idx)):
                    raise AssertionError(f"gather_rows row {r} be {be} lane"
                                         f" {lane}: the batched launch "
                                         "differs from a one-lane launch")
            if not torch.equal(rows, blocks[:, idx]):
                raise AssertionError(f"gather_rows row {r} be {be}: the "
                                     "batched launch differs from "
                                     "blocks[:, idx]")
        # timed at phase 4's rows
        for name, r in (("splu_pairs", named["argmax_pairs"]),
                        ("gather_rows", named["argmax_len"])):
            args = row_args(r)
            _, ln, _, npair, _, n_chunks, _ = dp["rows"][r]
            rec = out[name]
            if name == "splu_pairs":
                got = splu.splu_pairs(blocks, *args)
                plain = args[:3] + args[4:]     # no work list
                err, _ = assert_close(f"splu_pairs batched row {r} be {be}",
                                      got, splu._splu_pairs_plain(blocks,
                                                                  *plain))
                f_b = lambda: splu.splu_pairs(blocks, *args)  # noqa: E731
                f_1 = lambda: [splu.splu_pairs(blocks[lane], *args)  # noqa
                               for lane in range(B)]
                f_p = lambda: splu._splu_pairs_plain(blocks, *plain)  # noqa
                f_l = None          # no one library call computes it
                tiles = np.unique(np.concatenate([
                    pk["pair_l"][r, :npair], pk["pair_u"][r, :npair]])).size
                b_ms = bound(B * 8 * be * be * (tiles + ln)
                             + 4 * (2 * npair + 2 * ln) + 16 * n_chunks,
                             B * 2 * npair * be ** 3)
            else:
                idx = dp["dinv"][r, :ln]
                err = 0.0
                f_b = lambda: splu.gather_rows(blocks, idx)  # noqa: E731
                f_1 = lambda: [splu.gather_rows(blocks[lane], idx)  # noqa
                               for lane in range(B)]
                f_p = lambda: splu._gather_rows_plain(blocks, idx)  # noqa
                f_l = lambda: blocks.index_select(1, idx)  # noqa: E731
                b_ms = bound(B * 8 * be * be * (torch.unique(idx).numel()
                                                + ln) + 4 * ln, 0)
            ms, ms1, pms = time_ms(f_b), time_ms(f_1), time_ms(f_p)
            lms = None if f_l is None else time_ms(f_l)
            rec["ms"] += ms
            rec["singles_ms"] += ms1
            rec["plain_ms"] += pms
            if lms is not None:
                rec["library_ms"] = rec.get("library_ms", 0.0) + lms
            rec["bound_ms"] += b_ms[0]
            rec["bound_by"] = b_ms[1]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            say("batch_kernel", name=name, row=r, be=be, lanes=B, len=ln,
                pairs=npair, ms=ms, singles_ms=ms1, plain_ms=pms,
                library_ms=lms, bound_ms=b_ms[0], bound_by=b_ms[1],
                max_abs_err=err)
        del blocks
        torch.cuda.empty_cache()
    for k, row in (("splu_pairs", "argmax_pairs"),
                   ("gather_rows", "argmax_len")):
        out[k].update(lanes=B, rows_bit_identical=len(dp["rows"]),
                      shapes=f"npoint-{NPOINT} SPLU row ({row}), b 32 + "
                      f"2b 64, {B} lanes; every row held bit for bit")

    # gj_inv: B matrices' pivot blocks a launch, one threshold a matrix
    base = base_calls(gridmf_top_blocks(gplan))
    deltas = torch.tensor([1e-14, 1e-6] * (B // 2), dtype=torch.float64,
                          device=dev)
    rec = {"ms": 0.0, "singles_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "logdet_max_rel_err": 0.0, "shapes": [],
           "lanes": B}
    nbytes = flops = 0
    for (w, m), calls in sorted(base.items()):
        D = torch.cat([gj_inputs(w, m, 1000 * b + w + m) for b in range(B)])
        small = w >= 3 and m > 2
        if small:
            # a pivot of matrix 1 (in a lane without gj_inputs' zero
            # pivots) that its threshold (1e-6) catches and matrix 0's
            # (1e-14) would not
            j = w + (1 if w // 2 != 1 else 2)
            D[j, 1, :] *= 1e-5
            D[j, :, 1] *= 1e-5
        got = splu._gj_inv(D, deltas)
        want = splu._gj_inv_plain(D, deltas)
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"gj_inv ({B} x {w}, {m}): Dinv differs "
                                 "from the plain version")
        torch.testing.assert_close(got[1], want[1], rtol=1e-14, atol=0)
        for g, p in zip(got[2:], want[2:]):
            if not torch.equal(g, p):
                raise AssertionError(f"gj_inv ({B} x {w}, {m}): a statistic "
                                     "differs from the plain version")
        for b in range(B):
            one = splu._gj_inv(D[b * w:(b + 1) * w], deltas[b])
            if not all(torch.equal(g[b * w:(b + 1) * w], o)
                       for g, o in zip(got, one)):
                raise AssertionError(f"gj_inv ({B} x {w}, {m}) matrix {b}: "
                                     "the batched launch differs from a "
                                     "one-matrix launch")
        npert = got[3].view(B, w).sum(1).tolist()
        if min(npert) < 1 or (small and npert[1] != npert[0] + 1):
            raise AssertionError(f"gj_inv ({B} x {w}, {m}): n_perturbed per "
                                 f"matrix {npert}")
        lde = float(((got[1] - want[1]).abs() / want[1].abs()).max())
        rec["logdet_max_rel_err"] = max(rec["logdet_max_rel_err"], lde)
        one_d = [D[b * w:(b + 1) * w] for b in range(B)]
        ms = time_ms(gj_kernel_only(D, deltas))
        ms1 = time_ms(lambda: [splu._gj_inv(one_d[b], deltas[b])
                               for b in range(B)])
        pms = time_ms(lambda: splu._gj_inv_plain(D, deltas), reps=3,
                      warmup=1)
        rec["ms"] += calls * ms
        rec["singles_ms"] += calls * ms1
        rec["plain_ms"] += calls * pms
        wb, wf = gj_work(B * w, m)
        nbytes += calls * wb
        flops += calls * wf
        rec["shapes"].append([w, m, calls, npert])
        del D, got, want, one_d
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
    say("batch_kernel", name="gj_inv", per=f"npoint-{NPOINT} GRIDMF "
        f"factorize pair's base calls, {B} matrices a launch", **rec)
    out["gj_inv"] = rec
    torch.cuda.empty_cache()
    return out


# -- lin_solver_path ---------------------------------------------------------

GEOMETRIC_N = 263_743   # geometric_264k (BENCHMARKS.md §2)
LAPLACIAN_2D_NPOINT = 317
LAPLACIAN_3D_NPOINT = 50  # laplacian_3d_50, the reference's SPLU size
CLI_N = 30_000
LS_WARM_RUNS = 2
# the LinSolver path against SciPy's SuperLU: x and log|det|
LS_RTOL = {"genmf": 1e-9, "banded": 1e-10, "splu": 1e-10}
# SciPy's SuperLU of every (part, complex) of the path, on the host in a
# spawned pool beside the card's phases (start_oracles)
ORACLES = (("genmf", False), ("genmf", True), ("banded", False),
           ("banded", True), ("splu", False))
ORACLE_WORKERS = 2
ORACLE_TIMEOUT_S = 900
# the environment of a spawned host process: one BLAS/OpenMP thread
ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
                  "MKL_NUM_THREADS": "1"}


def perm_sign(p):
    """The sign of the permutation ``p``: (-1)^(n - number of cycles)."""
    p = np.asarray(p)
    seen = np.zeros(len(p), dtype=bool)
    cycles = 0
    for i in range(len(p)):
        if not seen[i]:
            cycles += 1
            j = i
            while not seen[j]:
                seen[j] = True
                j = p[j]
    return -1.0 if (len(p) - cycles) % 2 else 1.0


def superlu_oracle(coo, vals, bs):
    """SciPy's SuperLU on the host, independent of the port's numerics:
    x for each right-hand side of ``bs``, log|det| and the determinant's
    phase (sign for a real matrix). The matrix is symmetrically permuted
    by nested dissection first (``ordering.nd_ordering``; SuperLU's own
    MMD and COLAMD orderings take minutes at n 264k) and SuperLU keeps
    that column order, pivoting rows as it needs."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    from russell_tpu_torch.sparse.ordering import nd_ordering
    t0 = time.perf_counter()
    ii, jj, _ = coo.triplets()
    n = coo.nrow
    p = nd_ordering(n, ii, jj)
    ip = np.empty(n, dtype=np.int64)
    ip[p] = np.arange(n)
    a = sp.csc_matrix((vals, (ip[ii], ip[jj])), shape=(n, n))
    lu = spla.splu(a, permc_spec="NATURAL",
                   options={"SymmetricMode": True})
    xs = []
    for b in bs:
        y = lu.solve(np.asarray(b)[p])
        x = np.empty_like(y)
        x[p] = y
        xs.append(x)
    d = lu.U.diagonal()
    ad = np.abs(d)
    phase = complex(np.prod(d / ad)) * perm_sign(lu.perm_r) * perm_sign(
        lu.perm_c)
    return xs, float(np.sum(np.log(ad))), phase, time.perf_counter() - t0


def ls_inputs(part):
    """A lin_solver_path part's matrix, values and right-hand sides, drawn
    from its seed: (coo, vv, b, cv, cb) for "genmf" (geometric_264k) and
    "banded" (laplacian_2d_317), cv and cb the complex values and
    right-hand side; "splu" (laplacian_3d_50) has None for both."""
    from russell_tpu_torch.sparse import samples
    if part == "genmf":
        coo = samples.irregular_geometric(GEOMETRIC_N, seed=0)
        rng = np.random.default_rng(SEED)
    elif part == "banded":
        coo = samples.laplacian_2d(LAPLACIAN_2D_NPOINT)
        rng = np.random.default_rng(SEED + 1)
    else:
        coo = samples.laplacian_3d(LAPLACIAN_3D_NPOINT)
        rng = np.random.default_rng(SEED + 2)
    vv = coo.triplets()[2]
    b = rng.standard_normal(coo.nrow)
    if part == "splu":
        return coo, vv, b, None, None
    cv = vv + 0.3j * rng.standard_normal(len(vv))
    cb = b + 1j * rng.standard_normal(coo.nrow)
    return coo, vv, b, cv, cb


def oracle_job(part, complex_):
    """The pool's job: ``superlu_oracle`` of a part on its seeded inputs,
    with the host clock at its end."""
    coo, vv, b, cv, cb = ls_inputs(part)
    out = superlu_oracle(coo, cv if complex_ else vv,
                         [cb if complex_ else b])
    return out, time.time()


def low_priority():
    """A spawned host process's start: niced, one intra-op thread, so the
    host-stepped walls of the card's phases keep their host."""
    os.nice(10)
    torch.set_num_threads(1)


@contextlib.contextmanager
def one_thread_env():
    """ONE_THREAD_ENV in os.environ while the block starts processes."""
    old = {k: os.environ.get(k) for k in ONE_THREAD_ENV}
    os.environ.update(ONE_THREAD_ENV)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def start_oracles():
    """Start the SuperLU oracles of every (part, complex) in ORACLES in a
    spawned pool of ORACLE_WORKERS processes: {"pool", "jobs", "t0"}, for
    ``oracle`` to collect and ``stop_oracles`` to end."""
    import multiprocessing
    with one_thread_env():
        pool = multiprocessing.get_context("spawn").Pool(
            ORACLE_WORKERS, initializer=low_priority)
    return {"pool": pool, "t0": time.time(), "ends": {}, "waited_s": 0.0,
            "jobs": {key: pool.apply_async(oracle_job, key)
                     for key in ORACLES}}


def oracle(oracles, part, complex_):
    """The pool's SuperLU result of (part, complex_): (xs, log|det|,
    phase, its own seconds), waiting for it if it is not done."""
    t0 = time.perf_counter()
    out, end = oracles["jobs"][(part, complex_)].get(ORACLE_TIMEOUT_S)
    oracles["waited_s"] += time.perf_counter() - t0
    oracles["ends"][(part, complex_)] = end
    return out


def stop_oracles(oracles):
    """End the pool; returns its record: its own wall (start to the last
    job's end) and the time lin_solver_path waited for it."""
    oracles["pool"].terminate()
    oracles["pool"].join()
    ends = oracles["ends"].values()
    return {"pool_wall_s": (max(ends) - oracles["t0"]) if ends else None,
            "waited_s": oracles["waited_s"], "workers": ORACLE_WORKERS}


def det_log_phase(m, e):
    """(log|det|, phase) of a LinSolver determinant (mantissa, 10, e)."""
    return (np.log(abs(m)) + e * np.log(10.0)), complex(m) / abs(m)


def fac_log_phase(plan, fac):
    """(log|det|, phase) of the unscaled matrix from factor's factors."""
    from russell_tpu_torch.sparse import factor
    log_scale = float(torch.log(fac["rs"]).sum() + torch.log(fac["cs"]).sum())
    return (float(fac["logdet"]) - log_scale,
            complex(factor.det_phase(plan, fac)))


def check_oracle(name, x, logdet, phase, ox, ologdet, ophase, rtol):
    """Hold x, log|det| and the phase to SuperLU's at ``rtol``; returns
    the errors."""
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
    x_err = float(np.abs(x - ox).max() / np.abs(ox).max())
    ld_err = abs(logdet - ologdet) / abs(ologdet)
    ph_err = abs(phase - ophase)
    if not (x_err <= rtol and ld_err <= rtol and ph_err <= rtol):
        raise AssertionError(
            f"{name}: off SuperLU's (rtol {rtol}): x {x_err}, log|det| "
            f"{ld_err}, phase {phase} vs {ophase}")
    return {"x_rel_err_vs_superlu": x_err,
            "logdet_rel_err_vs_superlu": ld_err,
            "phase_err_vs_superlu": ph_err}


def timed_factorizations(fact, warm=LS_WARM_RUNS):
    """``fact()`` (which waits for its result) ``warm`` times after a cold
    call made by the caller: the walls, then one more under the profiler
    (device ms, device launches, busy share, gj_inv's launches and ms) and
    the peak memory of them all."""
    walls = []
    for _ in range(warm):
        t0 = time.perf_counter()
        fact()
        walls.append(time.perf_counter() - t0)
    n0 = gj_inv_launches()
    ms, p_wall, launches = kernel_device_ms(fact)
    dev_ms = sum(ms.values())
    return {"warm_wall_s": walls,
            "warm_median_s": statistics.median(walls),
            "warm_spread_s": max(walls) - min(walls),
            "device_ms": dev_ms, "device_launches": launches,
            "profiled_wall_s": p_wall,
            "device_busy_share": dev_ms / (1e3 * p_wall),
            "gj_inv_launches": gj_inv_launches() - n0,
            "gj_inv_device_ms": summed(ms, "gj_inv"),
            "top_kernels_ms": dict(sorted(ms.items(), key=lambda kv: -kv[1])
                                   [:5])}


def timed_solves(solve, reps=3):
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def kernel_counts():
    from russell_tpu_torch.sparse import splu
    return {"splu_pairs": splu.splu_pairs.launches,
            "gather_rows": splu.gather_rows.launches,
            "gj_inv": gj_inv_launches()}


@contextlib.contextmanager
def held_to_plain():
    """Within the block, every launch of gj_inv, splu_pairs and gather_rows
    (their f64 and f32 builds) is held against its plain version on the
    same inputs, as the kernel checks do: gj_inv's Dinv bit-identical,
    min|pivot|, n_perturbed and the sign exact, log|det| at rtol 1e-14 (f32
    2e-6); splu_pairs at rtol 1e-12 (f32: one ulp; ``assert_close``);
    gather_rows bit-identical. Yields {kernel: {"calls",
    "shapes", "max_abs_err"}} (gj_inv: also "logdet_max_rel_err"), filled
    as the block runs. The wrappers keep counting their launches."""
    from russell_tpu_torch.sparse import splu
    names = {"gj_inv": "_gj_inv", "splu_pairs": "splu_pairs",
             "gather_rows": "gather_rows"}
    orig = {k: getattr(splu, a) for k, a in names.items()}
    held = {k: {"calls": 0, "shapes": collections.Counter(),
                "max_abs_err": 0.0} for k in names}
    held["gj_inv"]["logdet_max_rel_err"] = 0.0

    def note(k, shape, err):
        h = held[k]
        h["calls"] += 1
        h["shapes"][shape] += 1
        h["max_abs_err"] = max(h["max_abs_err"], err)

    def gj_inv(D, delta):
        got = orig["gj_inv"](D, delta)
        want = splu._gj_inv_plain(D, delta)
        w, m = D.shape[0], D.shape[-1]
        if not torch.equal(got[0], want[0]):
            raise AssertionError(
                f"gj_inv ({w}, {m}) on the path: Dinv differs from the plain "
                f"version by up to {float((got[0] - want[0]).abs().max())}")
        torch.testing.assert_close(got[1], want[1],
                                   rtol=GJ_LOGDET_RTOL[D.dtype], atol=0,
                                   msg=lambda s: f"gj_inv ({w}, {m}) on the "
                                   f"path, log|det|: {s}")
        for name, g, p in (("min|pivot|", got[2], want[2]),
                           ("n_perturbed", got[3], want[3]),
                           ("sign", got[4], want[4])):
            if not torch.equal(g, p):
                raise AssertionError(f"gj_inv ({w}, {m}) on the path: {name} "
                                     "differs from the plain version")
        if w:   # the wrapper launches nothing for an empty batch
            note("gj_inv", (w, m), 0.0)
            h = held["gj_inv"]
            h["logdet_max_rel_err"] = max(h["logdet_max_rel_err"], float((
                (got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-300)
            ).max()))
        return got

    def splu_pairs(blocks, pair_l, pair_u, pair_seg, work, n_live, be):
        got = orig["splu_pairs"](blocks, pair_l, pair_u, pair_seg, work,
                                 n_live, be)
        want = splu._splu_pairs_plain(blocks, pair_l, pair_u, pair_seg,
                                      n_live, be)
        err, _ = assert_close(f"splu_pairs on the path ({n_live} lanes, "
                              f"{pair_l.numel()} pairs, be {be})", got, want)
        note("splu_pairs", (n_live, be), err)
        return got

    def gather_rows(blocks, idx):
        got = orig["gather_rows"](blocks, idx)
        if not torch.equal(got, splu._gather_rows_plain(blocks, idx)):
            raise AssertionError(f"gather_rows on the path ({idx.numel()} "
                                 "rows) differs from blocks[idx]")
        note("gather_rows", (idx.numel(), blocks.shape[1]), 0.0)
        return got

    checks = {"gj_inv": gj_inv, "splu_pairs": splu_pairs,
              "gather_rows": gather_rows}
    counts = ("launches", "launches_f32")
    for k, a in names.items():
        for c in counts:
            setattr(checks[k], c, getattr(orig[k], c, 0))
        setattr(splu, a, checks[k])
    try:
        yield held
    finally:
        for k, a in names.items():
            for c in counts:
                setattr(orig[k], c, getattr(checks[k], c))
            setattr(splu, a, orig[k])


def held_record(held, launches):
    """The record of a ``held_to_plain`` block that ran one factorization
    whose per-kernel launch counts were ``launches``: it fails unless every
    launch was held."""
    rec = {}
    for k, n in launches.items():
        h = held[k]
        if h["calls"] != n:
            raise AssertionError(f"{k}: {h['calls']} launches held against "
                                 f"the plain version, {n} in a factorization")
        if n:
            rec[k] = {"calls": h["calls"], "shapes": len(h["shapes"]),
                      "max_abs_err": h["max_abs_err"]}
            if "logdet_max_rel_err" in h:
                rec[k]["logdet_max_rel_err"] = h["logdet_max_rel_err"]
    return rec


def ls_genmf(res, oracles):
    """geometric_264k through LinSolver(Genie.GENMF), real; then the same
    pattern with complex values through factor on the solver's plan."""
    from russell_tpu_torch.sparse import (Genie, LinSolParams, LinSolver,
                                          VerifyLinSys, factor)
    coo, vv, b, cv, cb = ls_inputs("genmf")
    ii, jj, _ = coo.triplets()
    n = coo.nrow
    # AUTO's route for this matrix (host only): the reference package's
    # benchmark names GENMF (tools/bench_matrix_market.py:72)
    t0 = time.perf_counter()
    auto = factor.analyze(n, ii, jj)
    auto_s = time.perf_counter() - t0
    auto_rec = {"auto_routes_to": auto.genie.value,
                "auto_analyze_s": auto_s, "auto_block_k": auto.block_k}
    del auto
    reset_launch_counts()
    s = LinSolver(Genie.GENMF, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s.factorize(coo, LinSolParams())
    cold = time.perf_counter() - t0
    counts = kernel_counts()
    if counts["gj_inv"] <= 0:
        raise AssertionError("GENMF 264k: gj_inv was not launched")
    gp = s.plan.genmf_plan
    SHARED_PLANS["geometric_264k"] = s.plan
    rec = {"matrix": "geometric_264k", "n": n, "nnz": int(len(ii)),
           "solver": s.stats.main["solver"], **auto_rec,
           **gp.stats_dict(),
           "analyze_s": s.stats.time_nanoseconds["initialize"] / 1e9,
           "cold_factorize_s": s.stats.time_nanoseconds["factorize"] / 1e9,
           "cold_total_s": cold, "launches_cold": counts}
    rec.update(timed_factorizations(lambda: s.factorize(coo)))
    rec["GFLOP_per_s_wall"] = gp.flops / rec["warm_median_s"] / 1e9
    rec["GFLOP_per_s_device"] = gp.flops / rec["device_ms"] / 1e6
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    x = s.solve(b)
    rec["warm_solve_s"] = timed_solves(lambda: s.solve(b))
    m, _, e = s.determinant()
    logdet, phase = det_log_phase(m, e)
    rec["relative_error"] = VerifyLinSys.from_system(
        coo, x.cpu().numpy(), b).relative_error
    if not rec["relative_error"] <= 1e-10:
        raise AssertionError(f"GENMF 264k: relative error "
                             f"{rec['relative_error']}")
    rec["min_pivot"] = s.stats.output["min_pivot"]
    rec["n_perturbed"] = s.stats.output["n_perturbed_pivots"]
    # bits: another factorize-and-solve
    s.factorize(coo)
    rec["bit_identical_repeat"] = bool(torch.equal(s.solve(b), x))
    # gj_inv against its plain version: at every launch of a factorization,
    # and at the base shapes of both runs' pivot blocks with clamped lanes
    t0 = time.perf_counter()
    with held_to_plain() as held:
        s.factorize(coo)
    rec["held_to_plain"] = held_record(held, {"gj_inv": rec[
        "gj_inv_launches"]})
    ld_err = check_gj_inv_shapes({
        "genmf_264k": collections.Counter(
            (c.n_nodes, c.e) for c in gp.classes),
        "genmf_264k_complex": collections.Counter(
            (c.n_nodes, 2 * c.e) for c in gp.classes)})[1]
    rec["gj_inv_shapes_logdet_max_rel_err"] = ld_err
    rec["kernel_checks_s"] = time.perf_counter() - t0
    oxs, ologdet, ophase, t_o = oracle(oracles, "genmf", False)
    rec.update(check_oracle("GENMF 264k", x, logdet, phase, oxs[0], ologdet,
                            ophase, LS_RTOL["genmf"]), superlu_s=t_o,
               logdet=logdet, det_phase=str(phase))
    say("lin_solver_path", part="genmf_264k", **rec)
    if not rec["bit_identical_repeat"]:
        raise AssertionError("GENMF 264k: a second factorize-and-solve "
                             "changed x")
    res["genmf_264k"] = rec
    plan = s.plan
    del s, x
    gc.collect()
    torch.cuda.empty_cache()

    # complex values on the same plan, through the planes
    cvt = torch.as_tensor(cv, device="cuda")
    cbt = torch.as_tensor(cb, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    def fact():
        fac = factor.numeric_factorize(plan, cvt)
        float(fac["min_pivot"])
        return fac

    t0 = time.perf_counter()
    fac = fact()
    crec = {"cold_factorize_s": time.perf_counter() - t0}
    crec.update(timed_factorizations(fact))
    crec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    fac = fact()
    x = factor.factor_solve(plan, fac, cbt)
    crec["warm_solve_s"] = timed_solves(
        lambda: factor.factor_solve(plan, fac, cbt))
    logdet, phase = fac_log_phase(plan, fac)
    crec["relative_error"] = VerifyLinSys.from_system(
        coo.__class__.from_arrays(n, n, ii, jj, cv), x.cpu().numpy(),
        cb).relative_error
    if not crec["relative_error"] <= 1e-10:
        raise AssertionError(f"GENMF 264k complex: relative error "
                             f"{crec['relative_error']}")
    fac2 = fact()
    crec["bit_identical_repeat"] = bool(torch.equal(
        factor.factor_solve(plan, fac2, cbt), x))
    del fac2
    with held_to_plain() as held:
        fact()
    crec["held_to_plain"] = held_record(held, {"gj_inv": crec[
        "gj_inv_launches"]})
    oxs, ologdet, ophase, t_o = oracle(oracles, "genmf", True)
    crec.update(check_oracle("GENMF 264k complex", x, logdet, phase, oxs[0],
                             ologdet, ophase, LS_RTOL["genmf"]),
                superlu_s=t_o, logdet=logdet, det_phase=str(phase),
                min_pivot=float(fac["min_pivot"]),
                n_perturbed=int(fac["n_perturbed"]))
    say("lin_solver_path", part="genmf_264k_complex", **crec)
    if not crec["bit_identical_repeat"]:
        raise AssertionError("GENMF 264k complex: a second factorize-and-"
                             "solve changed x")
    res["genmf_264k_complex"] = crec
    del fac, x, cvt, cbt
    gc.collect()
    torch.cuda.empty_cache()


def ls_banded(res, oracles):
    """laplacian_2d_317 through LinSolver(Genie.AUTO) (BANDED, cyclic
    reduction), the sequential scan on the same matrix, and a complex run
    through cyclic reduction."""
    from russell_tpu_torch.sparse import (Genie, LinSolParams, LinSolver,
                                          VerifyLinSys, factor)
    coo, vv, b, cv, cb = ls_inputs("banded")
    ii, jj, _ = coo.triplets()
    n = coo.nrow
    s = LinSolver(Genie.AUTO, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    s.factorize(coo, LinSolParams())
    plan = s.plan
    if not (plan.genie == Genie.BANDED and plan.block_k == 320
            and plan.nb == 315 and plan.use_bcr):
        raise AssertionError(f"laplacian_2d_317: AUTO took {plan.genie} "
                             f"k {plan.block_k} nb {plan.nb} bcr "
                             f"{plan.use_bcr}, not BANDED 320/315/BCR")
    rec = {"matrix": "laplacian_2d_317", "n": n, "nnz": int(len(ii)),
           "block_k": plan.block_k, "nb": plan.nb,
           "analyze_s": s.stats.time_nanoseconds["initialize"] / 1e9,
           "cold_factorize_s": s.stats.time_nanoseconds["factorize"] / 1e9}
    rec.update(timed_factorizations(lambda: s.factorize(coo)))
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    x = s.solve(b)
    rec["warm_solve_s"] = timed_solves(lambda: s.solve(b))
    m, _, e = s.determinant()
    logdet, phase = det_log_phase(m, e)
    rec["relative_error"] = VerifyLinSys.from_system(
        coo, x.cpu().numpy(), b).relative_error
    s.factorize(coo)
    rec["bit_identical_repeat"] = bool(torch.equal(s.solve(b), x))
    oxs, ologdet, ophase, t_o = oracle(oracles, "banded", False)
    rec.update(check_oracle("BANDED BCR 317", x, logdet, phase, oxs[0],
                            ologdet, ophase, LS_RTOL["banded"]),
               superlu_s=t_o)
    say("lin_solver_path", part="banded_bcr_317", **rec)
    if not (rec["relative_error"] <= 1e-10 and rec["bit_identical_repeat"]):
        raise AssertionError(f"BANDED BCR 317: relative error "
                             f"{rec['relative_error']} or bits changed")
    res["banded_bcr_317"] = rec
    x_bcr = x
    del s
    gc.collect()
    torch.cuda.empty_cache()

    # the sequential scan on the same matrix
    splan = factor.analyze(n, ii, jj, genie=Genie.BANDED,
                           banded_kernel="scan")
    vt = torch.as_tensor(vv, device="cuda")
    bt = torch.as_tensor(b, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    def fact(p=splan, v=vt):
        fac = factor.numeric_factorize(p, v)
        float(fac["min_pivot"])
        return fac

    t0 = time.perf_counter()
    fact()
    srec = {"cold_factorize_s": time.perf_counter() - t0}
    srec.update(timed_factorizations(fact))
    srec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    fac = fact()
    x = factor.factor_solve(splan, fac, bt)
    srec["warm_solve_s"] = timed_solves(
        lambda: factor.factor_solve(splan, fac, bt))
    logdet, phase = fac_log_phase(splan, fac)
    srec["x_rel_err_vs_bcr"] = float((x - x_bcr).abs().max()
                                     / x_bcr.abs().max())
    srec.update(check_oracle("BANDED scan 317", x, logdet, phase, oxs[0],
                             ologdet, ophase, LS_RTOL["banded"]),
                n_perturbed=int(fac["n_perturbed"]),
                min_pivot=float(fac["min_pivot"]),
                bcr_over_scan_warm=rec["warm_median_s"]
                / srec["warm_median_s"])
    say("lin_solver_path", part="banded_scan_317", **srec)
    if not srec["x_rel_err_vs_bcr"] <= LS_RTOL["banded"]:
        raise AssertionError(f"BANDED 317: scan and BCR x differ by "
                             f"{srec['x_rel_err_vs_bcr']}")
    res["banded_scan_317"] = srec
    del fac, x, splan
    gc.collect()

    # complex128 through cyclic reduction
    cvt = torch.as_tensor(cv, device="cuda")
    cbt = torch.as_tensor(cb, device="cuda")
    t0 = time.perf_counter()
    fac = fact(plan, cvt)
    crec = {"cold_factorize_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    fac = fact(plan, cvt)
    crec["warm_factorize_s"] = time.perf_counter() - t0
    x = factor.factor_solve(plan, fac, cbt)
    logdet, phase = fac_log_phase(plan, fac)
    crec["relative_error"] = VerifyLinSys.from_system(
        coo.__class__.from_arrays(n, n, ii, jj, cv), x.cpu().numpy(),
        cb).relative_error
    oxs, ologdet, ophase, t_o = oracle(oracles, "banded", True)
    crec.update(check_oracle("BANDED BCR 317 complex", x, logdet, phase,
                             oxs[0], ologdet, ophase, LS_RTOL["banded"]),
                superlu_s=t_o)
    say("lin_solver_path", part="banded_bcr_317_complex", **crec)
    if not crec["relative_error"] <= 1e-10:
        raise AssertionError(f"BANDED 317 complex: relative error "
                             f"{crec['relative_error']}")
    res["banded_bcr_317_complex"] = crec
    del fac, x, plan, cvt, cbt, vt, bt, x_bcr
    gc.collect()
    torch.cuda.empty_cache()


def ls_splu(res, oracles):
    """laplacian_3d through LinSolver(Genie.SPLU): splu_pairs, gather_rows
    and gj_inv on the path, two runs bit-identical."""
    from russell_tpu_torch.sparse import (Genie, LinSolParams, LinSolver,
                                          VerifyLinSys)
    coo, vv, b, _, _ = ls_inputs("splu")
    ii, jj, _ = coo.triplets()
    n = coo.nrow
    reset_launch_counts()
    s = LinSolver(Genie.SPLU, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    s.factorize(coo, LinSolParams())
    counts = kernel_counts()
    for k, v in counts.items():
        if v <= 0:
            raise AssertionError(f"SPLU via LinSolver: {k} was not launched")
    rec = {"matrix": f"laplacian_3d_{LAPLACIAN_3D_NPOINT}", "n": n,
           "nnz": int(len(ii)), "nblk": s.plan.splu_plan.nblk,
           "rows": len(s.plan.splu_plan.packed["t0"]),
           "analyze_s": s.stats.time_nanoseconds["initialize"] / 1e9,
           "cold_factorize_s": s.stats.time_nanoseconds["factorize"] / 1e9,
           "launches_per_factorization": counts}
    rec.update(timed_factorizations(lambda: s.factorize(coo)))
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    x = s.solve(b)
    rec["warm_solve_s"] = timed_solves(lambda: s.solve(b))
    m, _, e = s.determinant()
    logdet, phase = det_log_phase(m, e)
    rec["relative_error"] = VerifyLinSys.from_system(
        coo, x.cpu().numpy(), b).relative_error
    blocks = s.fac["blocks"].clone()
    s.factorize(coo)
    rec["bit_identical_repeat"] = bool(torch.equal(s.fac["blocks"], blocks)
                                       and torch.equal(s.solve(b), x))
    # every kernel launch of a factorization against its plain version
    t0 = time.perf_counter()
    with held_to_plain() as held:
        s.factorize(coo)
    rec["held_to_plain"] = held_record(held, counts)
    rec["kernel_checks_s"] = time.perf_counter() - t0
    oxs, ologdet, ophase, t_o = oracle(oracles, "splu", False)
    rec.update(check_oracle("SPLU via LinSolver", x, logdet, phase, oxs[0],
                            ologdet, ophase, LS_RTOL["splu"]),
               superlu_s=t_o)
    say("lin_solver_path", part="splu_3d", **rec)
    if not (rec["relative_error"] <= 1e-10 and rec["bit_identical_repeat"]):
        raise AssertionError(f"SPLU via LinSolver: relative error "
                             f"{rec['relative_error']} or bits changed")
    res["splu_3d"] = rec
    del s, x, blocks
    gc.collect()
    torch.cuda.empty_cache()


def ls_cli(res):
    """solve_matrix_market in a subprocess with its default flags (AUTO, on
    the card) on a MatrixMarket file of irregular_geometric(CLI_N); its
    solver must be the one factor.analyze picks for that matrix."""
    import tempfile
    from russell_tpu_torch.sparse import factor, samples, write_matrix_market
    root = os.path.dirname(os.path.abspath(__file__))
    coo = samples.irregular_geometric(CLI_N, seed=0)
    ii, jj, _ = coo.triplets()
    auto = factor.analyze(coo.nrow, ii, jj).genie.value
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"geometric_{CLI_N}.mtx")
        write_matrix_market(coo, path)
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "russell_tpu_torch.bin.solve_matrix_market",
             path, "--determinant"], cwd=root, env=env,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
    out = proc.stdout
    if proc.returncode != 0 or "{" not in out:
        raise AssertionError(f"solve_matrix_market exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    st = json.loads(out[out.index("{"):])
    rec = {"rc": proc.returncode, "wall_s": wall, "auto_routes_to": auto,
           "solver": st["main"]["solver"], "platform": st["main"]["platform"],
           "relative_error": st["verify"]["relative_error"],
           "time_ns": st["time_nanoseconds"]}
    say("lin_solver_path", part="cli", n=CLI_N, **rec)
    if (rec["solver"].lower() != auto
            or not rec["relative_error"] <= 1e-10):
        raise AssertionError(f"solve_matrix_market: {rec}")
    res["cli"] = rec


def phase_lin_solver_path(oracles=None):
    """LinSolver on the card at the reference's sparse benchmark sizes
    (GENMF geometric_264k real and complex, BANDED laplacian_2d_317 by
    cyclic reduction and by the scan, SPLU laplacian_3d_50) against SciPy's
    SuperLU, then the solve_matrix_market CLI. The SuperLU results come
    from ``oracles`` (``start_oracles``, started at the smoke's start),
    else from a pool started here."""
    t0 = time.perf_counter()
    own = oracles is None
    if own:
        oracles = start_oracles()
    res = {}
    try:
        ls_genmf(res, oracles)
        ls_banded(res, oracles)
        ls_splu(res, oracles)
    finally:
        if own:
            res["superlu_pool"] = stop_oracles(oracles)
    ls_cli(res)
    res["superlu_waited_s"] = oracles["waited_s"]
    say("lin_solver_path", part="done", wall_s=time.perf_counter() - t0,
        superlu_waited_s=oracles["waited_s"])
    return res



# -- pde_path ------------------------------------------------------------------

PDE_NPOINT = 1025       # Poisson at 1,046,529 unknowns: AUTO -> GRIDMF
PDE_SPLU_NPOINT = 513   # the same problem through Genie.SPLU
PDE_SPC_N = 48          # Spc2d on Kopriva's problem, through DENSE
PDE_RING_N = 15         # SpcMap2d on the quarter ring (tests/test_pde.py)
# the leaf fronts' eliminated cells that gridmf_analyze makes for this grid
# at leaf 64 (49 at leaf 16): AUTO takes leaf 64 (3 x 3.06 GiB <= 15)
PDE_LEAF64_E = 225
PDE_RES_RTOL = 1e-10
# tests/test_pde.py:101-107's 5e-5 at 41 x 41, scaled by h^2 (with room)
PDE_ERR = 2e-7
PDE_SPC_ERR = 1e-9      # tests/test_pde.py's bound for Kopriva at 24 x 24
PDE_RING_ERR = 1e-9     # tests/test_pde.py's bound for the ring


def poisson_fdm(npoint, genie=None):
    """``d2_problem_01(True)`` (Poisson, homogeneous Dirichlet, analytic phi)
    on an npoint x npoint grid, solving on the card: (fdm, source, phi)."""
    from russell_tpu_torch.pde import Fdm2d, Grid2d, problem_samples
    (xmin, xmax, ymin, ymax, kx, ky, ebcs, nbcs, src, ana, _) = \
        problem_samples.d2_problem_01(True)
    grid = Grid2d.new_uniform(xmin, xmax, ymin, ymax, npoint, npoint)
    fdm = Fdm2d(grid, ebcs, nbcs, kx, ky, device="cuda")
    if genie is not None:
        fdm.set_solver_options(genie)
    return fdm, src, ana


def max_error(solver, a, ana):
    """max |a[m] - ana(x_m, y_m)| over the solver's nodes."""
    err = [0.0]

    def cb(m, x, y):
        err[0] = max(err[0], abs(a[m] - ana(x, y)))

    solver.for_each_coord(cb)
    return err[0]


def timed_user_solve(fdm, src):
    """``fdm.solve_sps(0, src)`` — the user's call: host assembly, analysis,
    factorization and solve — with its wall."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = fdm.solve_sps(0.0, src)
    return a, time.perf_counter() - t0


def pde_gridmf(res):
    """Poisson at PDE_NPOINT through one LinSolver on the SPS system that
    ``Fdm2d.solve_sps`` builds (AUTO + the grid hint: GRIDMF): assembly,
    analysis, a cold and LS_WARM_RUNS warm factorizations, one more with
    every gj_inv launch held to its plain version, a solve, the residual
    and the error against phi; then ``solve_sps`` twice, bit-identical to
    each other and to the LinSolver's x."""
    from russell_tpu_torch.sparse import Genie, LinSolParams, LinSolver
    from russell_tpu_torch.sparse import gridmf
    fdm, src, ana = poisson_fdm(PDE_NPOINT)
    t0 = time.perf_counter()
    kk_bar, kk_check = fdm.get_matrices_sps(0.0)
    _, a_check, f_bar = fdm.get_vectors_sps(src)
    rhs = f_bar - kk_check.mat_vec_mul(a_check)
    assembly_s = time.perf_counter() - t0
    hint = fdm._sps_grid_hint()
    if hint != (PDE_NPOINT - 2, PDE_NPOINT - 2, 1):
        raise AssertionError(f"pde_path: grid hint {hint}")
    reset_launch_counts()
    s = LinSolver(Genie.AUTO, device="cuda")
    params = LinSolParams()
    params.grid = hint
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s.factorize(kk_bar, params)
    cold = time.perf_counter() - t0
    if s.plan.genie != Genie.GRIDMF:
        raise AssertionError(f"pde_path: AUTO took {s.plan.genie}")
    gp = s.plan.gridmf_plan
    leaf_e = gp.levels[-1].e
    if leaf_e != PDE_LEAF64_E:
        raise AssertionError(f"pde_path: leaf fronts of {leaf_e} cells, not "
                             "leaf 64's")
    launches = kernel_counts()
    if launches["gj_inv"] <= 0:
        raise AssertionError("pde_path: gj_inv was not launched")
    rec = {"npoint": PDE_NPOINT, "n": kk_bar.nrow, "nnz": kk_bar.nnz,
           "solver": s.stats.main["solver"], "grid_hint": list(hint),
           "assembly_s": assembly_s,
           "analyze_s": s.stats.time_nanoseconds["initialize"] / 1e9,
           "leaf_e": leaf_e, "depths": len(gp.levels),
           "store_gb_per_plane": gridmf.gridmf_store_gb(gp),
           "cold_factorize_s": s.stats.time_nanoseconds["factorize"] / 1e9,
           "cold_total_s": cold, "launches_cold_factorization": launches}
    rec.update(timed_factorizations(lambda: s.factorize(kk_bar)))
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    # one more factorization with every gj_inv launch held to its plain
    # version: the leaf fronts and the Schur-split separators at this grid
    # are shapes that no other phase checks
    t0 = time.perf_counter()
    with held_to_plain() as held:
        s.factorize(kk_bar)
    rec["held_to_plain"] = held_record(held, launches)
    rec["held_wall_s"] = time.perf_counter() - t0
    x = s.solve(rhs)
    rec["warm_solve_s"] = timed_solves(lambda: s.solve(rhs))
    b = torch.as_tensor(rhs, device="cuda")
    rec["relative_residual"] = residual(s.plan, s._vals_full, x, b)
    a_ls = fdm.get_joined_vector_sps(x.cpu().numpy(), a_check)
    rec["max_error_vs_phi"] = max_error(fdm, a_ls, ana)
    del s, x, b
    gc.collect()
    torch.cuda.empty_cache()
    a1, rec["solve_sps_wall_s"] = timed_user_solve(fdm, src)
    a2, rec["solve_sps_again_wall_s"] = timed_user_solve(fdm, src)
    rec["bit_identical_repeat"] = bool(np.array_equal(a1, a2))
    rec["solve_sps_equals_lin_solver"] = bool(np.array_equal(a1, a_ls))
    say("pde_path", part=f"gridmf_{PDE_NPOINT}", **rec)
    if not (rec["relative_residual"] <= PDE_RES_RTOL
            and rec["max_error_vs_phi"] <= PDE_ERR):
        raise AssertionError(f"pde_path GRIDMF: residual "
                             f"{rec['relative_residual']}, error "
                             f"{rec['max_error_vs_phi']}")
    if not (rec["bit_identical_repeat"] and rec["solve_sps_equals_lin_solver"]):
        raise AssertionError("pde_path GRIDMF: solve_sps changed bits")
    res[f"gridmf_{PDE_NPOINT}"] = rec


def pde_splu(res):
    """The same problem at PDE_SPLU_NPOINT through ``Genie.SPLU``, its
    kernels counted from zero over a ``solve_sps``; x held to the GRIDMF
    solution at that size; a second ``solve_sps`` with every launch held
    to its plain version, bit-identical to the first."""
    from russell_tpu_torch.sparse import Genie
    fdm, src, ana = poisson_fdm(PDE_SPLU_NPOINT, Genie.SPLU)
    reset_launch_counts()
    a, wall = timed_user_solve(fdm, src)
    counts = kernel_counts()
    for k, v in counts.items():
        if v <= 0:
            raise AssertionError(f"pde_path SPLU: {k} was not launched")
    gfdm, _, _ = poisson_fdm(PDE_SPLU_NPOINT)
    reset_launch_counts()
    ag, gwall = timed_user_solve(gfdm, src)
    rec = {"npoint": PDE_SPLU_NPOINT, "n": fdm.equations.nu(),
           "solve_sps_wall_s": wall, "launches_solve_sps": counts,
           "gridmf_solve_sps_wall_s": gwall,
           "gridmf_gj_inv_launches": kernel_counts()["gj_inv"],
           "rel_diff_vs_gridmf": float(np.abs(a - ag).max()
                                       / np.abs(ag).max()),
           "max_error_vs_phi": max_error(fdm, a, ana)}
    t0 = time.perf_counter()
    with held_to_plain() as held:
        a2 = fdm.solve_sps(0.0, src)
    rec["held_to_plain"] = held_record(held, counts)
    rec["held_wall_s"] = time.perf_counter() - t0
    rec["bit_identical_repeat"] = bool(np.array_equal(a, a2))
    say("pde_path", part=f"splu_{PDE_SPLU_NPOINT}", **rec)
    if not (rec["rel_diff_vs_gridmf"] <= 1e-10
            and rec["bit_identical_repeat"]):
        raise AssertionError(f"pde_path SPLU: {rec}")
    res[f"splu_{PDE_SPLU_NPOINT}"] = rec


def quarter_ring():
    """The quarter annulus r in [1, 2], theta in [0, pi/2] of
    tests/test_pde.py, as a Transfinite2d."""
    import math
    from russell_tpu_torch.pde import Transfinite2d
    a, b_ = 1.0, 2.0
    q = math.pi / 4

    def th(s):
        return (s + 1.0) * q

    B = [lambda s: np.array([a * math.cos(th(s)), a * math.sin(th(s))]),
         lambda s: np.array([b_ * math.cos(th(s)), b_ * math.sin(th(s))]),
         lambda r: np.array([(a + b_) / 2 + (b_ - a) / 2 * r, 0.0]),
         lambda r: np.array([0.0, (a + b_) / 2 + (b_ - a) / 2 * r])]
    dB = [lambda s: np.array([-a * math.sin(th(s)) * q,
                              a * math.cos(th(s)) * q]),
          lambda s: np.array([-b_ * math.sin(th(s)) * q,
                              b_ * math.cos(th(s)) * q]),
          lambda r: np.array([(b_ - a) / 2, 0.0]),
          lambda r: np.array([0.0, (b_ - a) / 2])]
    ddB = [lambda s: np.array([-a * math.cos(th(s)) * q ** 2,
                               -a * math.sin(th(s)) * q ** 2]),
           lambda s: np.array([-b_ * math.cos(th(s)) * q ** 2,
                               -b_ * math.sin(th(s)) * q ** 2]),
           lambda r: np.array([0.0, 0.0]),
           lambda r: np.array([0.0, 0.0])]
    return Transfinite2d(B, dB, ddB)


def pde_spectral(res):
    """Spc2d on Kopriva's problem at PDE_SPC_N^2 and SpcMap2d on the
    quarter ring at PDE_RING_N^2, through DENSE on the card, against the
    analytic solutions."""
    import math
    from russell_tpu_torch.pde import (EssentialBcs2d, NaturalBcs2d, Side,
                                       Spc2d, SpcMap2d, problem_samples)
    (xmin, xmax, ymin, ymax, kx, ky, ebcs, nbcs, src, ana) = \
        problem_samples.d2_problem_07()
    t0 = time.perf_counter()
    spc = Spc2d(xmin, xmax, ymin, ymax, PDE_SPC_N, PDE_SPC_N, ebcs, nbcs,
                kx, ky, device="cuda")
    a = spc.solve_sps(0.0, src)
    rec = {"spc2d_n": PDE_SPC_N, "spc2d_unknowns": spc.equations.nu(),
           "spc2d_wall_s": time.perf_counter() - t0,
           "spc2d_max_error": max_error(spc, a, ana)}
    ring_ana = lambda x, y: math.log(math.hypot(x, y)) / math.log(2.0)
    ebcs = EssentialBcs2d()
    ebcs.set(Side.XMIN, lambda x, y: 0.0)
    ebcs.set(Side.XMAX, lambda x, y: 1.0)
    ebcs.set(Side.YMIN, ring_ana)
    ebcs.set(Side.YMAX, ring_ana)
    t0 = time.perf_counter()
    ring = SpcMap2d(PDE_RING_N, PDE_RING_N, quarter_ring(), ebcs,
                    NaturalBcs2d(), k=1.0, device="cuda")
    a = ring.solve_sps(0.0, lambda x, y: 0.0)
    rec.update(ring_n=PDE_RING_N, ring_wall_s=time.perf_counter() - t0,
               ring_max_error=max_error(ring, a, ring_ana))
    say("pde_path", part="spectral", **rec)
    if not (rec["spc2d_max_error"] <= PDE_SPC_ERR
            and rec["ring_max_error"] <= PDE_RING_ERR):
        raise AssertionError(f"pde_path spectral: {rec}")
    res["spectral"] = rec


def phase_pde_path():
    """Fdm2d, Spc2d and SpcMap2d on the card: Poisson at PDE_NPOINT^2
    through AUTO -> GRIDMF, at PDE_SPLU_NPOINT^2 through SPLU, and the
    spectral solvers. Kernel launches are counted from zero within each
    run and reported per run."""
    t0 = time.perf_counter()
    res = {}
    pde_gridmf(res)
    gc.collect()
    torch.cuda.empty_cache()
    pde_splu(res)
    gc.collect()
    torch.cuda.empty_cache()
    pde_spectral(res)
    res["wall_s"] = time.perf_counter() - t0
    say("pde_path", part="done", wall_s=res["wall_s"])
    return res


# -- nonlin_path ---------------------------------------------------------------

NONLIN_COUNTERS = ("n_steps", "n_accepted", "n_rejected", "n_function",
                   "n_jacobian", "n_factor", "n_lin_sol", "n_iteration_total")
# russell_tpu's CPU runs (f64) of the configurations below
BRATU_17_COUNTERS = (11, 11, 0, 40, 36, 36, 82, 40)
BRATU_17_STEP_L = (
    0.0, 0.4960955796883189, 1.2515741593031895, 2.279314040278554,
    3.562074739662457, 4.979582019300316, 6.241583538730863,
    6.801253135163321, 6.042066376691407, 4.545577772064729,
    2.6130363866949895, 1.0499269471279535)
BRATU_17_FOLD = 6.80217410        # the npoint-17 discrete fold
BRATU_1D_COUNTERS = (14, 14, 0, 40, 34, 34, 33, 40)
BSPLINE_COUNTERS = (62, 62, 0, 124, 63, 63, 62, 124)
BRATU_BIG = 257                   # ndim 65,025
BRATU_BK = 6.80812442259          # Bolstad & Keller's lambda_crit
# the discrete folds of russell_tpu's CPU runs (f64): arclength as
# tests/test_nonlin.py runs it, then its dense extended-system polish
BRATU_REF_FOLDS = {17: 6.80217409562718, 33: 6.806652729201835}
# |fold at BRATU_BIG - bratu_fold_expected(BRATU_BIG)|: the h^6 term left
# out of the fit is about 1e-9 there
BRATU_BIG_FOLD_TOL = 1e-7
BRATU_BIG_PROFILED_STEPS = 3


def bratu_fold_expected(npoint):
    """The 2-D Bratu FDM fold at ``npoint``: BRATU_BK less c h^2 - d h^4,
    with c and d fitted to BRATU_REF_FOLDS (h = 1 / (npoint - 1))."""
    (n1, f1), (n2, f2) = sorted(BRATU_REF_FOLDS.items())
    h1, h2 = 1.0 / (n1 - 1), 1.0 / (n2 - 1)
    c, d = np.linalg.solve([[h1 ** 2, -h1 ** 4], [h2 ** 2, -h2 ** 4]],
                           [BRATU_BK - f1, BRATU_BK - f2])
    h = 1.0 / (npoint - 1)
    return BRATU_BK - c * h ** 2 + d * h ** 4


def continuation(sample, args, method, stop, ddl, record=None,
                 callback=None, profile=False, **cfg):
    """One ``Solver.solve`` on the card from the sample's start: (u, status,
    counters tuple, Output, wall s, solver, mid, setup s, profile), the
    Output's step callback ``callback``. The sample and the Solver (its Gu
    analysis) are built first, their wall ``setup s``; with ``profile`` only the solve runs under the profiler
    (``kernel_device_ms``'s triple, else None)."""
    from russell_tpu_torch import nonlin
    t0 = time.perf_counter()
    system, u0, l0, *rest = getattr(nonlin.samples, sample)(*args)
    mid = rest[0] if rest and isinstance(rest[0], int) else None
    solver = nonlin.Solver(nonlin.Config(method=method, **cfg), system,
                           device="cuda")
    out = nonlin.Output().set_recording(record if record is not None
                                        else [mid])
    if callback is not None:
        out.set_step_callback(callback)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    got = []

    def run():
        got.append(solver.solve(u0, l0, nonlin.IniDir.POS, stop(mid), ddl,
                                output=out))

    prof = None
    t0 = time.perf_counter()
    if profile:
        prof = kernel_device_ms(run)
    else:
        run()
    wall = time.perf_counter() - t0
    u, _, status = got[0]
    st = solver.stats()
    return (u, status, tuple(getattr(st, k) for k in NONLIN_COUNTERS), out,
            wall, solver, mid, setup, prof)


def check_counters_nl(name, got, want):
    if tuple(got) != tuple(want):
        raise AssertionError(f"nonlin_path {name}: counters "
                             f"{dict(zip(NONLIN_COUNTERS, got))}, the "
                             f"reference's {dict(zip(NONLIN_COUNTERS, want))}")


def dense_gu(system):
    """(l, u) -> the system's Gu as a dense matrix on u's device."""
    n = system.ndim

    def gu(l, u):
        ii = torch.as_tensor(system.jac_ii, device=u.device)
        jj = torch.as_tensor(system.jac_jj, device=u.device)
        vals, _ = system.calc_jac(l, u, None)
        return torch.zeros((n, n), dtype=u.dtype, device=u.device).index_put(
            (ii, jj), vals, accumulate=True)
    return gu


def fold_polish(system, u, l, gu):
    """The fold of G by extended-system Newton in torch on u's device:
    [G; Gu v; v_k - 1] = 0 over z = (u, v, lambda), with ``gu(l, u)`` the
    dense Gu (``dense_gu``), as tests/test_nonlin.py polishes it in jax;
    returns lambda."""
    n = system.ndim
    w, vv = torch.linalg.eig(gu(l, u))
    v = vv[:, torch.argmin(w.abs())].real
    k = int(torch.argmax(v.abs()))
    z = torch.cat([u, v / v[k], torch.tensor([l], dtype=u.dtype,
                                             device=u.device)])

    def ff(z):
        uu, vv_, ll = z[:n], z[n:2 * n], z[2 * n]
        return torch.cat([system.calc_gg(ll, uu, None), gu(ll, uu) @ vv_,
                          (vv_[k] - 1.0)[None]])

    for _ in range(30):
        dz = torch.linalg.solve(torch.func.jacfwd(ff)(z), -ff(z))
        z = z + dz
        if float(dz.abs().max()) < 1e-11:
            break
    return float(z[2 * n])


def fold_polish_sparse(system, plan, u, l, max_iter=20):
    """The fold of G by the same extended-system Newton with Gu sparse, on
    u's device: each iteration factors Gu through ``factor`` on ``plan``
    (the system's Gu pattern, prepared on that device) and solves the
    (2n + 1) system by block elimination with four Gu solves (Keller's
    bordering), then once more on that solve's residual: Gu is near
    singular at the fold, and one step of refinement keeps the block
    elimination's error from steering u along Gu's null vector. The second
    derivatives (Gu v)_u x and (Gu v)_lambda are forward-mode products of
    Gu's entries (``torch.func.jvp``). The start v comes from inverse
    iteration on Gu. Returns (lambda, {"iterations", "last_dl", "last_du",
    "g_max", "guv_max"}), the last two the residuals at the fold."""
    from russell_tpu_torch.sparse import factor, ordering, splu
    dev = u.device
    n = system.ndim
    order, offsets = ordering.segment_index(system.jac_ii, n)
    order = None if order is None else torch.as_tensor(order, device=dev)
    offsets = torch.as_tensor(offsets, device=dev)
    jj = torch.as_tensor(system.jac_jj, device=dev)

    def times(vals, x):
        """Gu x for the Gu entries ``vals``."""
        return splu.segment_sum(vals * x[jj], order, offsets)

    def factored(ll, uu):
        vals, ggl = system.calc_jac(ll, uu, None)
        fac = factor.numeric_factorize(plan, vals)
        return (lambda b: factor.factor_solve(plan, fac, b)), vals, ggl

    l = torch.tensor(l, dtype=u.dtype, device=dev)
    solve, _, _ = factored(l, u)
    v = torch.ones_like(u)
    for _ in range(8):
        v = solve(v)
        v = v / v.abs().max()
    k = int(torch.argmax(v.abs()))
    v = v / v[k]
    info = {}
    for it in range(1, max_iter + 1):
        solve, vals, ggl = factored(l, u)

        def b_times(x, uu=u, ll=l, vv=v):
            """(Gu v)_u x: the entries' tangent along x, times v."""
            return times(torch.func.jvp(
                lambda w: system.calc_jac(ll, w, None)[0], (uu,), (x,))[1], vv)

        c_l = times(torch.func.jvp(
            lambda ll: system.calc_jac(ll, u, None)[0], (l,),
            (torch.ones_like(l),))[1], v)
        a2 = solve(ggl)
        b2 = solve(b_times(a2) - c_l)

        def block_solve(r1, r2, r3):
            """(du, dv, dl) with [Gu 0 G_l; B Gu C_l; 0 e_k 0] (du, dv, dl)
            = (r1, r2, r3)."""
            a1 = solve(r1)
            b1 = solve(r2 - b_times(a1))
            dl = (r3 - b1[k]) / b2[k]
            return a1 - dl * a2, b1 + dl * b2, dl

        r = (-system.calc_gg(l, u, None), -times(vals, v), 1.0 - v[k])
        du, dv, dl = block_solve(*r)
        cu, cv, cl = block_solve(
            r[0] - times(vals, du) - ggl * dl,
            r[1] - b_times(du) - times(vals, dv) - c_l * dl,
            r[2] - dv[k])
        du, dv, dl = du + cu, dv + cv, dl + cl
        u, v, l = u + du, v + dv, l + dl
        info = {"iterations": it, "last_dl": float(dl.abs()),
                "last_du": float(du.abs().max())}
        if info["last_dl"] < 1e-13:
            break
    vals, _ = system.calc_jac(l, u, None)
    info.update(g_max=float(system.calc_gg(l, u, None).abs().max()),
                guv_max=float(times(vals, v).abs().max()))
    return float(l), info


def phase_nonlin_path():
    """The continuation solvers on the card: the 2-D Bratu problem by
    arclength at npoint 17 (the reference's counters and steps, the fold
    polished in torch) and at BRATU_BIG with the default Config (AUTO's
    route, steps, walls, the busy share of the first steps, through the
    fold, the fold polished through ``factor`` and held to the h^2-h^4 fit
    of the reference's folds; a second run bit-identical), and natural
    continuation on the 1-D Bratu and the B-spline problems (the
    reference's counters)."""
    from russell_tpu_torch import nonlin
    t0_all = time.perf_counter()
    arc, nat = nonlin.Method.ARCLENGTH, nonlin.Method.NATURAL
    res = {}
    n17 = list(range(225))
    u, status, cnt, out, wall, solver, mid, _, _ = continuation(
        "bratu_2d_fdm", (17,), arc, lambda m: nonlin.Stop.max_comp_u(m, 6.0),
        nonlin.DeltaLambda.auto(0.5), record=n17)
    ls = np.asarray(out.step_l)
    j = int(np.argmax(ls))
    uj = torch.as_tensor(np.array([out.step_u(m)[j] for m in n17]),
                         device="cuda")
    system = solver.actual.system
    t0 = time.perf_counter()
    lam = fold_polish(system, uj, float(ls[j]), dense_gu(system))
    rec = {"route": solver.actual.ls.plan.genie.value, "status": status.name,
           "counters": dict(zip(NONLIN_COUNTERS, cnt)), "wall_s": wall,
           "step_l_max_abs_err": float(np.abs(ls - BRATU_17_STEP_L).max())
           if len(ls) == len(BRATU_17_STEP_L) else None,
           "fold_lambda": lam, "fold_err": abs(lam - BRATU_17_FOLD),
           "polish_s": time.perf_counter() - t0}
    say("nonlin_path", part="bratu_2d_17", **rec)
    check_counters_nl("bratu_2d_17", cnt, BRATU_17_COUNTERS)
    if not (status.success() and rec["step_l_max_abs_err"] is not None
            and rec["step_l_max_abs_err"] <= 1e-9 and rec["fold_err"] <= 1e-5):
        raise AssertionError(f"nonlin_path bratu_2d_17: {rec}")
    res["bratu_2d_17"] = rec

    top = {}

    def keep_top(stats, h, l, uu, args):
        if not top or l > top["l"]:
            top.update(l=l, u=uu.copy())
        return False

    runs = []
    for r in range(2):
        u, status, cnt, out, wall, solver, mid, setup, _ = continuation(
            "bratu_2d_fdm", (BRATU_BIG,), arc,
            lambda m: nonlin.Stop.max_comp_u(m, 6.0),
            nonlin.DeltaLambda.auto(0.5),
            callback=keep_top if r == 0 else None)
        runs.append((u, status, cnt, np.asarray(out.step_l),
                     np.asarray(out.step_u(mid)), wall, solver, setup))
    u, status, cnt, ls, umid, wall, solver, setup = runs[0]
    plan = solver.actual.ls.plan
    t0 = time.perf_counter()
    lam, polish = fold_polish_sparse(
        solver.actual.system, plan,
        torch.as_tensor(top["u"], device="cuda"), top["l"])
    polish_s = time.perf_counter() - t0
    # the busy share of the first BRATU_BIG_PROFILED_STEPS steps: the
    # sample and the Solver are built outside the profiled solve
    _, _, _, _, _, _, _, p_setup, (ms, p_wall, launches) = \
        continuation("bratu_2d_fdm", (BRATU_BIG,), arc,
                     lambda m: nonlin.Stop.steps(BRATU_BIG_PROFILED_STEPS),
                     nonlin.DeltaLambda.auto(0.5), profile=True)
    j = int(np.argmax(ls))
    expected = bratu_fold_expected(BRATU_BIG)
    rec = {"npoint": BRATU_BIG, "ndim": solver.ndim, "route": plan.genie.value,
           "block_k": plan.block_k, "nb": plan.nb, "bcr": plan.use_bcr,
           "tg_control_tol": solver.config.tg_control_tol,
           "status": status.name,
           "counters": dict(zip(NONLIN_COUNTERS, cnt)),
           "setup_s": [r[7] for r in runs], "wall_s": [r[5] for r in runs],
           "lambda_max": float(ls[j]),
           "u_mid_at_lambda_max": float(umid[j]), "u_mid_last": float(umid[-1]),
           "steps_recorded": len(ls),
           "fold_lambda": lam, "fold_expected": expected,
           "fold_err": abs(lam - expected), "polish": polish,
           "polish_s": polish_s,
           "fold_minus_lambda_max": lam - float(ls[j]),
           "profiled_steps": BRATU_BIG_PROFILED_STEPS,
           "profiled_setup_s": p_setup, "profiled_solve_wall_s": p_wall,
           "device_ms": sum(ms.values()), "device_launches": launches,
           "device_busy_share": sum(ms.values()) / (1e3 * p_wall),
           "top_kernels_ms": dict(sorted(ms.items(), key=lambda kv: -kv[1])
                                  [:5]),
           "repeat_counters_equal": runs[1][2] == cnt,
           "repeat_bit_identical": bool(np.array_equal(runs[1][0], u)
                                        and np.array_equal(runs[1][3], ls))}
    say("nonlin_path", part=f"bratu_2d_{BRATU_BIG}", **rec)
    rises_then_falls = (0 < j < len(ls) - 1 and np.all(np.diff(ls[:j + 1]) > 0)
                        and ls[-1] < ls[j])
    if not (status.success() and rises_then_falls and umid[-1] >= 6.0
            and rec["fold_err"] <= BRATU_BIG_FOLD_TOL
            and ls[j] <= lam + 1e-9 and top["l"] == ls[j]
            and rec["repeat_counters_equal"] and rec["repeat_bit_identical"]):
        raise AssertionError(f"nonlin_path bratu_2d_{BRATU_BIG}: {rec}")
    res[f"bratu_2d_{BRATU_BIG}"] = rec
    del runs, solver
    gc.collect()
    torch.cuda.empty_cache()

    for name, sample, args, stop, ddl, want in (
            ("bratu_1d_natural", "bratu_1d_spc", (20,),
             lambda m: nonlin.Stop.max_lambda(3.4),
             nonlin.DeltaLambda.auto(0.5), BRATU_1D_COUNTERS),
            ("bspline_natural", "bspline_problem_1", (),
             lambda m: nonlin.Stop.max_lambda(1.0),
             nonlin.DeltaLambda.auto(0.01), BSPLINE_COUNTERS)):
        u, status, cnt, out, wall, solver, _, _, _ = continuation(
            sample, args, nat, stop, ddl, record=[0])
        rec = {"route": solver.actual.ls.plan.genie.value,
               "status": status.name,
               "counters": dict(zip(NONLIN_COUNTERS, cnt)), "wall_s": wall}
        say("nonlin_path", part=name, **rec)
        check_counters_nl(name, cnt, want)
        if not status.success():
            raise AssertionError(f"nonlin_path {name}: {rec}")
        res[name] = rec
    res["wall_s"] = time.perf_counter() - t0_all
    say("nonlin_path", part="done", wall_s=res["wall_s"],
        kernels="none: DENSE and BANDED run cuSOLVER/cuBLAS")
    return res


# -- 24. lab_path: core, math, dense and algo on the card ----------------------

LAB_N = 4096              # dense f64 (mat_mat_mul ... mat_eigen_sym)
LAB_N_HERM = 2048         # mat_eigen_herm (c128), mat_svd, pseudo-inverse
LAB_N_EIG = 1024          # mat_eigen (a batch of LAB_EIG_BATCH), gen_eigen
LAB_EIG_BATCH = 2
LAB_RES_TOL = 1e-12       # residuals relative to the norms of the operands
LAB_REPS = 3              # timed dense calls after the first (set-up) one
LAB_POINTS = 1 << 24      # special functions: 128 MiB an f64 tensor
LAB_ORACLE_STRIDE = 64    # every 64th point against scipy (2^18 points)
LAB_SLOW_STRIDE = 1024    # for jn/yn/in of order 50, whose scipy is slow
LAB_CPU_POINTS = 4096     # points of the port's CPU run
# the card against the CPU run where scipy is held more loosely
LAB_CPU_TOL = {"beta(b>=8)": 1e-13, "ln_beta(b>=8)": 1e-13}
JACOBI_PLAIN_N = (2, 8, 32)   # kernel against its plain version on the CPU
JACOBI_N = (128, 256)         # both on the cluster route
NEWTON_N = (64, 2048)
# the reference's counters (russell_tpu on the CPU): RootFinder on x^4 - 1
# (chebyshev, refine) then brent on sin in [2, 4]: (n_function, n_jacobian,
# n_iterations); MinBracketing from 0 and MinSolver.brent on
# (x - 2)^2 + 1 + 0.1 sin 5x: (n_function, n_iterations) each; Quadrature
# of sqrt(1 - x^2) on [-1, 1]: (n_function, n_iterations)
LAB_ROOT_COUNTERS = (58, 0, 7)
LAB_MIN_COUNTERS = ((12, 10), (14, 14))
LAB_QUAD_COUNTERS = (1770, 30)


def lab_timed(fn):
    """(fn(), host wall s, device ms): one call between two CUDA events,
    ending in a synchronize."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end)


def lab_check(name, err, tol):
    if not err <= tol:
        raise AssertionError(f"lab_path {name}: {err:.3e} > {tol:.1e}")
    return err


def lab_counters(name, got, want):
    if tuple(got) != tuple(want):
        raise AssertionError(f"lab_path {name}: counters {got}, the "
                             f"reference's {want}")


def inf_norm(x):
    x = np.asarray(x)
    return float(np.abs(x).sum(axis=-1).max()) if x.ndim > 1 else float(
        np.abs(x).max())


def lab_matrix(n, gen, dtype=torch.float64):
    """I + 0.1 G / sqrt(n), G seeded standard normal on the card: well
    conditioned, det finite."""
    g = torch.randn((n, n), generator=gen, dtype=dtype, device="cuda")
    return torch.eye(n, dtype=dtype, device="cuda") + (0.1 / n ** 0.5) * g


def lab_dense():
    """The dense surface at users' sizes, each result held on the host by
    its invariant against seeded vectors y (Freivalds): residuals relative
    to the operands' inf-norms <= LAB_RES_TOL. Each call's first run on
    its shapes is set-up (``first_wall_s``, ``first_device_ms``: cuSOLVER
    or MAGMA handles and workspaces); its time is the median of LAB_REPS
    calls after it, one at a time."""
    from russell_tpu_torch.core import Norm
    from russell_tpu_torch.dense import (
        mat_cholesky, mat_eigen, mat_eigen_herm, mat_eigen_sym, mat_gen_eigen,
        mat_inverse, mat_mat_mul, mat_norm, mat_pseudo_inverse, mat_svd,
        solve_lin_sys)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    out = {}
    n = LAB_N
    A, B = lab_matrix(n, gen), lab_matrix(n, gen)
    S = A @ A.mT
    Ah, Bh, Sh = A.cpu().numpy(), B.cpu().numpy(), S.cpu().numpy()
    y = rng.standard_normal(n)
    nA, nB, nS = inf_norm(Ah), inf_norm(Bh), inf_norm(Sh)
    lab_check("mat_norm", abs(float(mat_norm(A, Norm.INF)) - nA) / nA, 1e-14)

    def rec(name, fn, flops=None):
        res, first_wall, first_ms = lab_timed(fn)
        runs = [lab_timed(fn)[1:] for _ in range(LAB_REPS)]
        wall = statistics.median(r[0] for r in runs)
        dev_ms = statistics.median(r[1] for r in runs)
        r = {"wall_s": wall, "device_ms": dev_ms, "first_wall_s": first_wall,
             "first_device_ms": first_ms}
        if flops:
            r["gflops"] = flops / (dev_ms * 1e6)
        out[name] = r
        return res

    C = rec("mat_mat_mul", lambda: mat_mat_mul(1.0, A, B), 2.0 * n ** 3)
    out["mat_mat_mul"]["residual"] = lab_check(
        "mat_mat_mul", inf_norm(C.cpu().numpy() @ y - Ah @ (Bh @ y))
        / (nA * nB * inf_norm(y)), LAB_RES_TOL)
    L = rec("mat_cholesky", lambda: mat_cholesky(S), n ** 3 / 3.0)
    Lh = L.cpu().numpy()
    out["mat_cholesky"]["residual"] = lab_check(
        "mat_cholesky", inf_norm(Lh @ (Lh.T @ y) - Sh @ y)
        / (nS * inf_norm(y)), LAB_RES_TOL)
    b = torch.as_tensor(y, device="cuda")
    x = rec("solve_lin_sys", lambda: solve_lin_sys(A, b),
            2.0 * n ** 3 / 3.0 + 2.0 * n ** 2)
    xh = x.cpu().numpy()
    out["solve_lin_sys"]["residual"] = lab_check(
        "solve_lin_sys", inf_norm(Ah @ xh - y) / (nA * inf_norm(xh)),
        LAB_RES_TOL)
    inv, det = rec("mat_inverse", lambda: mat_inverse(A), 2.0 * n ** 3)
    ih = inv.cpu().numpy()
    sign, logdet = np.linalg.slogdet(Ah)
    out["mat_inverse"].update(
        residual=lab_check("mat_inverse", inf_norm(Ah @ (ih @ y) - y)
                           / (nA * inf_norm(ih) * inf_norm(y)), LAB_RES_TOL),
        det=float(det), det_rel_err=lab_check(
            "det", abs(float(det) - sign * np.exp(logdet))
            / abs(sign * np.exp(logdet)), 1e-10))
    del C, L, inv, x
    w, V = rec("mat_eigen_sym", lambda: mat_eigen_sym(S))
    wh, Vh = w.cpu().numpy(), V.cpu().numpy()
    out["mat_eigen_sym"].update(
        residual=lab_check("mat_eigen_sym", inf_norm(
            Sh @ (Vh @ y) - Vh @ (wh * y)) / (nS * inf_norm(Vh)
                                            * inf_norm(y)), LAB_RES_TOL),
        orthogonality=lab_check("mat_eigen_sym orthogonality", inf_norm(
            Vh.T @ (Vh @ y) - y) / inf_norm(y), 1e-12))
    del A, B, S, V, Ah, Bh, Sh, Vh
    torch.cuda.empty_cache()
    m = LAB_N_HERM
    G = lab_matrix(m, gen, torch.complex128)
    H = (G + G.mH) / 2
    Hh = H.cpu().numpy()
    yc = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    w, V = rec("mat_eigen_herm", lambda: mat_eigen_herm(H))
    wh, Vh = w.cpu().numpy(), V.cpu().numpy()
    out["mat_eigen_herm"]["residual"] = lab_check(
        "mat_eigen_herm", inf_norm(Hh @ (Vh @ yc) - Vh @ (wh * yc))
        / (inf_norm(Hh) * inf_norm(Vh) * inf_norm(yc)), LAB_RES_TOL)
    A2 = lab_matrix(m, gen)
    A2h = A2.cpu().numpy()
    y2 = y[:m]
    s, U, Vt = rec("mat_svd", lambda: mat_svd(A2))
    sh, Uh, Vth = s.cpu().numpy(), U.cpu().numpy(), Vt.cpu().numpy()
    out["mat_svd"]["residual"] = lab_check(
        "mat_svd", inf_norm(Uh @ (sh * (Vth @ y2)) - A2h @ y2)
        / (inf_norm(A2h) * inf_norm(y2)), LAB_RES_TOL)
    P = rec("mat_pseudo_inverse", lambda: mat_pseudo_inverse(A2))
    Ph = P.cpu().numpy()
    out["mat_pseudo_inverse"]["residual"] = lab_check(
        "mat_pseudo_inverse", inf_norm(A2h @ (Ph @ y2) - y2)
        / (inf_norm(A2h) * inf_norm(Ph) * inf_norm(y2)), LAB_RES_TOL)
    del G, H, V, A2, U, Vt, P
    torch.cuda.empty_cache()
    k = LAB_N_EIG
    Ab = torch.stack([lab_matrix(k, gen) for _ in range(LAB_EIG_BATCH)])
    Bg = lab_matrix(k, gen)
    yk = y[:k] + 0j

    def eig_residual(name, planes, a, bmat=None):
        lr, li, vr, vi = (t.cpu().numpy() for t in planes)
        lam, Vc = lr + 1j * li, vr + 1j * vi
        res = 0.0
        for i in range(lam.shape[0] if lam.ndim > 1 else 1):
            li_, Vi = (lam[i], Vc[i]) if lam.ndim > 1 else (lam, Vc)
            ai = a[i] if a.ndim > 2 else a
            rhs = Vi @ (li_ * yk)
            if bmat is not None:
                rhs = bmat @ rhs
            res = max(res, inf_norm(ai @ (Vi @ yk) - rhs) / (
                inf_norm(ai) * inf_norm(Vi) * inf_norm(yk)
                * (1.0 if bmat is None else inf_norm(bmat))))
        return lab_check(name, res, LAB_RES_TOL)

    planes = rec("mat_eigen_batched", lambda: mat_eigen(Ab))
    if not all(t.device == Ab.device for t in planes):
        raise AssertionError("mat_eigen: planes left the card")
    out["mat_eigen_batched"]["residual"] = eig_residual(
        "mat_eigen", planes, Ab.cpu().numpy())
    planes = rec("mat_gen_eigen", lambda: mat_gen_eigen(Ab[0], Bg))
    out["mat_gen_eigen"]["residual"] = eig_residual(
        "mat_gen_eigen", planes, Ab[0].cpu().numpy(), Bg.cpu().numpy())
    del Ab, Bg, planes
    torch.cuda.empty_cache()
    return out


def jacobi_work(n, sweeps, route):
    """(bytes, flops, from_code) of one decomposition on ``route``: A read
    and V and w written once; per rotation 18 n + 13 flops (rows and
    columns of A and V: 6 flops an updated pair of entries; the rotation's
    scalars), n (n - 1) / 2 rotations a sweep. ``from_code`` holds counts
    that follow from the kernel's code, not measured: its rounds, m - 1 a
    sweep (m = n rounded up to even), and its barriers. One CTA runs two
    CTA barriers a round, two in its set-up and one at the end; a cluster
    runs one CTA barrier and two cluster barriers a round (the arrive and
    wait around V^T's rows, the sync after A's blocks), one of each in its
    set-up and a cluster barrier at the end."""
    rot = sweeps * n * (n - 1) // 2
    rounds = sweeps * (n + n % 2 - 1)
    cta = route == "cta"
    return 8 * (2 * n * n + n), rot * (18 * n + 13), {
        "rounds": rounds,
        "cta_barriers": 2 * rounds + 3 if cta else rounds + 1,
        "cluster_barriers": 0 if cta else 2 * rounds + 2}


def lab_sym(n, seed):
    if n == 2:
        return np.array([[2.0, 1.0], [1.0, 2.0]])  # equal diagonal
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / 2


def jacobi_forced(route, fn, ctas=None):
    """fn() with jacobi_eig's shared-memory budget lowered so that n 32 or
    33 takes ``route``: "cluster" (4 KB: a cluster CTA's share fits, one
    CTA's rows do not), "global" (1 KB) or "cta" (the budget as it is);
    ``ctas``, where given, caps the cluster's CTAs (JACOBI_CLUSTER)."""
    from russell_tpu_torch.dense import matrix_ops
    saved = matrix_ops.JACOBI_SMEM_BYTES, matrix_ops.JACOBI_CLUSTER
    try:
        matrix_ops.JACOBI_SMEM_BYTES = {"cta": saved[0], "cluster": 4096,
                                        "global": 1024}[route]
        matrix_ops.JACOBI_CLUSTER = ctas or saved[1]
        return fn()
    finally:
        matrix_ops.JACOBI_SMEM_BYTES, matrix_ops.JACOBI_CLUSTER = saved


def lab_jacobi():
    """jacobi_eig bit for bit against its plain version (run on the CPU)
    at JACOBI_PLAIN_N, the largest on every route (one CTA, the cluster of
    16 CTAs and of 8, the portable size, the cluster on global scratch);
    the plain version on the card once;
    then mat_eigen_sym_jacobi at JACOBI_N (the main window: its launches),
    each launch held bit for bit to the plain version run on the card,
    eigenvalues within LAB_RES_TOL ||A|| of torch.linalg.eigh, |A V - V w|
    within LAB_RES_TOL ||A|| and |V^T V - I| within LAB_RES_TOL, with the
    route and its CTAs, the kernel's time, the plain version's, the bound,
    the rounds and barriers that follow from the kernel's code
    (``jacobi_work``), ns a round and eigh's time at each n."""
    from russell_tpu_torch.dense import mat_eigen_sym_jacobi, matrix_ops
    sweeps = matrix_ops.JACOBI_SWEEPS
    held = []
    for n in JACOBI_PLAIN_N:
        a = lab_sym(n, n)
        t0 = time.perf_counter()
        plain_cpu = matrix_ops._jacobi_eig_plain(torch.as_tensor(a), sweeps)
        plain_cpu_s = time.perf_counter() - t0
        ac = torch.as_tensor(a, device="cuda")
        routes = [("cta", None)] + ([("cluster", None), ("cluster", 8),
                                     ("global", None)]
                                    if n == JACOBI_PLAIN_N[-1] else [])
        for route, ctas in routes:
            def run():
                got = matrix_ops._jacobi_route(n)
                if got[0] != route or (ctas and got[1] != ctas):
                    raise AssertionError(f"jacobi_eig n {n}: {got[:2]}, not "
                                         f"the {route} route on {ctas}")
                w, V = matrix_ops.jacobi_eig(ac)
                return w.cpu(), V.cpu(), got[1]
            w, V, used = jacobi_forced(route, run, ctas)
            if not (torch.equal(w, plain_cpu[0])
                    and torch.equal(V, plain_cpu[1])):
                raise AssertionError(f"jacobi_eig n {n} ({route}, {used} "
                                     "CTAs): not the plain version's bits")
            held.append({"n": n, "route": route, "ctas": used,
                         "bit_identical": True,
                         "max_abs_err": max(
                             float((w - plain_cpu[0]).abs().max()),
                             float((V - plain_cpu[1]).abs().max())),
                         "plain_cpu_s": plain_cpu_s})
    n = JACOBI_PLAIN_N[-1]
    a = torch.as_tensor(lab_sym(n, n), device="cuda")
    (wpc, Vpc), _, plain_ms = lab_timed(
        lambda: matrix_ops._jacobi_eig_plain(a, sweeps))
    if not (torch.equal(wpc.cpu(), plain_cpu[0])
            and torch.equal(Vpc.cpu(), plain_cpu[1])):
        raise AssertionError("jacobi_eig's plain version: other bits on the "
                             "card than on the CPU")
    route, ctas = matrix_ops._jacobi_route(n)[:2]
    nb, fl, from_code = jacobi_work(n, sweeps, route)
    bms, by = bound(nb, fl)
    kms = time_ms(lambda: matrix_ops.jacobi_eig(a), reps=5)
    small = {"n": n, "route": route, "ctas": ctas, "ms": kms,
             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
             "from_code": from_code,
             "ns_per_round": 1e6 * kms / from_code["rounds"],
             "library_ms": time_ms(lambda: torch.linalg.eigh(a), reps=5)}
    mats = {n: torch.as_tensor(lab_sym(n, n), device="cuda")
            for n in JACOBI_N}
    matrix_ops.reset_launch_counts()
    outs = {n: mat_eigen_sym_jacobi(mats[n]) for n in JACOBI_N}
    outs = {n: (w.cpu(), V.cpu()) for n, (w, V) in outs.items()}
    launches = matrix_ops.jacobi_eig.launches
    if launches != len(JACOBI_N):
        raise AssertionError(f"jacobi_eig: {launches} launches on the path")
    at_n = {}
    for n in JACOBI_N:
        rec = jacobi_main_held(n, outs, sweeps)
        held.append(rec)
        w, V = (t.cuda() for t in outs[n])
        we = torch.linalg.eigvalsh(mats[n])
        scale = float(torch.linalg.matrix_norm(mats[n], 2))
        err = lab_check(f"jacobi n {n}",
                        float((w - we).abs().max()) / scale, LAB_RES_TOL)
        resid = lab_check(f"jacobi n {n} |A V - V w|", float(
            (mats[n] @ V - V * w).abs().max()) / scale, LAB_RES_TOL)
        orth = lab_check(f"jacobi n {n} |V^T V - I|", float(
            (V.mT @ V - torch.eye(n, dtype=V.dtype, device=V.device))
            .abs().max()), LAB_RES_TOL)
        nb, fl, from_code = jacobi_work(n, sweeps, rec["route"])
        bms, by = bound(nb, fl)
        kms = statistics.median(lab_timed(
            lambda: matrix_ops.jacobi_eig(mats[n]))[2] for _ in range(3))
        at_n[n] = {"route": rec["route"], "ctas": rec["ctas"], "ms": kms,
                   "plain_ms": rec["plain_ms"], "bound_ms": bms,
                   "bound_by": by, "from_code": from_code,
                   "ns_per_round": 1e6 * kms / from_code["rounds"],
                   "eig_max_rel_err": err, "residual": resid,
                   "orthogonality": orth,
                   "library_ms": time_ms(lambda: torch.linalg.eigh(mats[n]),
                                         reps=5)}
    return {"held_to_plain": held, "launches": launches, "small": small,
            "at_n": at_n}


def jacobi_plain_sorted(n, sweeps, device="cpu"):
    """(w, V, device ms or host s): the plain version of jacobi_eig on
    lab_sym(n, n) on ``device``, sorted as mat_eigen_sym_jacobi sorts; on
    the card timed by CUDA events, on the CPU by the host clock."""
    from russell_tpu_torch.dense import matrix_ops
    a = torch.as_tensor(lab_sym(n, n), device=device)
    if a.device.type == "cuda":
        (w, V), _, took = lab_timed(
            lambda: matrix_ops._jacobi_eig_plain(a, sweeps))
    else:
        t0 = time.perf_counter()
        w, V = matrix_ops._jacobi_eig_plain(a, sweeps)
        took = time.perf_counter() - t0
    order = torch.argsort(w, stable=True)
    return w[order].cpu(), V[:, order].cpu(), took


def jacobi_main_held(n, outs, sweeps, device="cuda"):
    """The main window's launch at ``n`` (``outs[n]``, mat_eigen_sym_jacobi's
    (w, V) on the host) against the plain version run on ``device``, bit for
    bit; a held_to_plain record with the plain version's time."""
    from russell_tpu_torch.dense import matrix_ops
    wp, Vp, took = jacobi_plain_sorted(n, sweeps, device)
    w, V = outs[n]
    if not (torch.equal(w, wp) and torch.equal(V, Vp)):
        raise AssertionError(f"mat_eigen_sym_jacobi n {n} (the main path's "
                             "launch): not the plain version's bits")
    route, ctas = (matrix_ops._jacobi_route(n)[:2] if device == "cuda"
                   else (None, None))
    return {"n": n, "route": route, "ctas": ctas, "main_path": True,
            "bit_identical": True, "max_abs_err": max(
                float((w - wp).abs().max()), float((V - Vp).abs().max())),
            ("plain_ms" if device == "cuda" else "plain_cpu_s"): took}


def lab_inputs(edges, lo, hi, seed):
    """LAB_POINTS f64 inputs: ``edges`` first, then seeded uniform draws
    in [lo, hi), made on the host."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, LAB_POINTS)
    x[:len(edges)] = edges
    return x


BESSEL_EDGES = (0.0, 1.0, -1.0, -3.0, -8.0, -17.0, -26.0, 8.0, 17.0, 26.0,
                np.nextafter(8.0, 0), np.nextafter(8.0, 9),
                np.nextafter(17.0, 0), np.nextafter(17.0, 18),
                np.nextafter(26.0, 0), np.nextafter(26.0, 27), 200.0)


def lab_special_specs():
    """(name, port call on the inputs, scipy oracle on the host inputs,
    inputs (name: (edges, lo, hi)), tolerance kind, tolerance, stride):
    every elementwise public function of ``math``, at the tolerances of
    tests/test_math.py ("abs": |d| <= tol; "rel1": |d| <= tol max(|w|, 1);
    "rel": |d| <= tol |w|)."""
    from russell_tpu_torch import math as pm
    from scipy import special as ss
    pos = ((0.0, 1.0, 8.0, 17.0, 26.0, 200.0), 1e-6, 200.0)
    jx = (BESSEL_EDGES, -200.0, 200.0)
    ix = ((0.0, 1.0, -1.0, 30.0, -30.0), -30.0, 30.0)
    kx = ((0.0, -1.0, 1.0, 2.0, 60.0), 1e-5, 60.0)
    unit = ((-1.0, 0.0, 1.0), -1.0, 1.0)

    def ynan(w, x):
        """scipy's Y at x < 0 is NaN by the reference's contract too."""
        w[x < 0] = np.nan
        return w

    def gamma_ref(x):
        w = ss.gamma(x)
        w[(x <= 0) & (x == np.floor(x))] = np.nan
        return w

    def pi_ref(n, phi, m):
        s, c = np.sin(phi), np.cos(phi)
        return s * ss.elliprf(c * c, 1 - m * s * s, 1.0) + n * s ** 3 / 3 \
            * ss.elliprj(c * c, 1 - m * s * s, 1.0, 1 - n * s * s)

    def cheb(kind, n, d):
        # T_n, or U_n = sum of 2 T_j over j = n, n-2, ... (T_0 once), as a
        # Chebyshev series: numpy differentiates and sums it by Clenshaw
        c = np.zeros(n + 1)
        if kind == "T":
            c[n] = 1.0
        else:
            c[n % 2::2] = 2.0
            c[0] = 1.0 if n % 2 == 0 else 0.0
        cc = np.polynomial.chebyshev.chebder(c, d) if d else c
        return lambda x: np.polynomial.chebyshev.chebval(x, cc)

    def leg(n, d):
        c = np.zeros(n + 1)
        c[n] = 1.0
        cc = np.polynomial.legendre.legder(c, d) if d else c
        return lambda x: np.polynomial.legendre.legval(x, cc)

    S = LAB_ORACLE_STRIDE
    specs = [
        ("bessel_j0", pm.bessel_j0, ss.j0, {"x": jx}, "abs", 2e-15, S),
        ("bessel_j1", pm.bessel_j1, ss.j1, {"x": jx}, "abs", 2e-15, S),
        # Y0/Y1: test_math.py's 2e-14 absolute where |Y| <= 1 and relative
        # above (near 0, where -2/(pi x) dominates, an ulp of CUDA's log
        # moves the sum's rounding by an ulp of |Y|)
        ("bessel_y0", pm.bessel_y0, lambda x: ynan(ss.y0(x), x), {"x": jx},
         "rel1", 2e-14, S),
        ("bessel_y1", pm.bessel_y1, lambda x: ynan(ss.y1(x), x), {"x": jx},
         "rel1", 2e-14, S),
        ("bessel_jn(20)", lambda x: pm.bessel_jn(20, x),
         lambda x: ss.jv(20, x), {"x": jx}, "rel1", 1e-14, S),
        ("bessel_jn(50)", lambda x: pm.bessel_jn(50, x),
         lambda x: ss.jv(50, x), {"x": jx}, "rel1", 1e-14, LAB_SLOW_STRIDE),
        ("bessel_yn(20)", lambda x: pm.bessel_yn(20, x),
         lambda x: ynan(ss.yn(20, x), x), {"x": pos}, "rel1", 1e-13, S),
        ("bessel_i0", pm.bessel_i0, ss.i0, {"x": ix}, "rel1", 1e-13, S),
        ("bessel_i1", pm.bessel_i1, ss.i1, {"x": ix}, "rel1", 1e-13, S),
        ("bessel_in(5)", lambda x: pm.bessel_in(5, x),
         lambda x: ss.iv(5, x), {"x": ix}, "rel1", 1e-13, S),
        ("bessel_in(50)", lambda x: pm.bessel_in(50, x),
         lambda x: ss.iv(50, x), {"x": ix}, "rel1", 1e-13, LAB_SLOW_STRIDE),
        ("bessel_k0", pm.bessel_k0, ss.k0, {"x": kx}, "rel", 1e-13, S),
        ("bessel_k1", pm.bessel_k1, ss.k1, {"x": kx}, "rel", 1e-13, S),
        ("bessel_kn(10)", lambda x: pm.bessel_kn(10, x),
         lambda x: ss.kn(10, x), {"x": kx}, "rel", 1e-13, S),
        ("gamma", pm.gamma, gamma_ref,
         {"x": ((0.0, -1.0, -2.0, -7.0, 1.0, 0.5, -0.5, -2.5), -10.0, 40.0)},
         "rel", 1e-13, S),
        ("ln_gamma", pm.ln_gamma, ss.gammaln,
         {"x": ((0.5, 1.0, 2.0, 3.7), 0.01, 100.0)}, "rel1", 1e-13, S),
        ("beta", pm.beta, ss.beta, {"a": ((2.0, 0.5), 0.1, 7.9),
                                    "b": ((3.0, 0.5), 0.1, 7.9)},
         "rel", 1e-13, S),
        ("ln_beta", pm.ln_beta, ss.betaln, {"a": ((2.0,), 0.1, 7.9),
                                            "b": ((3.0,), 0.1, 7.9)},
         "rel1", 1e-13, S),
        # max(a, b) >= 8 and large arguments: the reference's algdiv (jax's
        # copy of cdflib's, ROADMAP.md section 3) is up to 6.4e-7 of
        # max(|ln B|, 1) off scipy's betaln, so 1.4e-6 relative in B; the
        # CPU run is held at 1e-13 (LAB_CPU_TOL)
        ("beta(b>=8)", pm.beta, ss.beta,
         {"a": ((0.5, 3.0, 30.0, 1e3, 1e6), 0.1, 30.0),
          "b": ((8.0, 9.0, 1e2, 1e5, 1e7), 8.0, 1e3)}, "rel", 2e-6, S),
        ("ln_beta(b>=8)", pm.ln_beta, ss.betaln,
         {"a": ((0.5, 3.0, 30.0, 1e3, 1e6), 0.1, 1e4),
          "b": ((8.0, 9.0, 1e2, 1e5, 1e7), 8.0, 1e6)}, "rel1", 1e-6, S),
        ("erf", pm.erf, ss.erf, {"x": ((0.0, 1.0, -1.0), -6.0, 6.0)},
         "abs", 1e-14, S),
        ("erfc", pm.erfc, ss.erfc, {"x": ((0.0, 1.0, -1.0), -6.0, 6.0)},
         "abs", 1e-14, S),
        ("erf_inv", pm.erf_inv, ss.erfinv,
         {"x": ((1.0, -1.0, 0.0, 1.5, -2.0), -0.999, 0.999)}, "rel", 1e-9,
         S),
        ("erfc_inv", pm.erfc_inv, ss.erfcinv,
         {"x": ((0.0, 1.0, 2.0), 0.001, 1.999)}, "rel", 1e-9, S),
        ("logistic", pm.logistic, ss.expit, {"x": ((0.0,), -30.0, 30.0)},
         "abs", 1e-15, S),
        ("logistic_deriv1", pm.logistic_deriv1,
         lambda x: ss.expit(x) * (1 - ss.expit(x)),
         {"x": ((0.0,), -30.0, 30.0)}, "abs", 1e-15, S),
        ("sign", pm.sign, np.sign, {"x": ((0.0, -1.0, 1.0), -5.0, 5.0)},
         "abs", 0.0, S),
        ("ramp", pm.ramp, lambda x: np.maximum(x, 0.0),
         {"x": ((0.0, -1.0, 1.0), -5.0, 5.0)}, "abs", 0.0, S),
        ("heaviside", pm.heaviside, lambda x: np.heaviside(x, 0.5),
         {"x": ((0.0, -1.0, 1.0), -5.0, 5.0)}, "abs", 0.0, S),
        ("boxcar", lambda x: pm.boxcar(x, -1.0, 2.0),
         lambda x: np.heaviside(x + 1.0, 0.5) - np.heaviside(x - 2.0, 0.5),
         {"x": ((-1.0, 2.0, 0.0), -5.0, 5.0)}, "abs", 0.0, S),
        ("smooth_ramp", lambda x: pm.smooth_ramp(x, 2.0),
         lambda x: np.where(-2 * x > 500, 0.0, x + np.log1p(np.exp(-2 * x))
                            / 2), {"x": ((0.0, -300.0, 300.0), -20.0, 20.0)},
         "rel1", 1e-14, S),
        ("smooth_ramp_deriv1", lambda x: pm.smooth_ramp_deriv1(x, 2.0),
         lambda x: ss.expit(2 * x), {"x": ((0.0, 300.0), -20.0, 20.0)},
         "abs", 1e-15, S),
        ("smooth_ramp_deriv2", lambda x: pm.smooth_ramp_deriv2(x, 2.0),
         lambda x: 2 * ss.expit(2 * x) * ss.expit(-2 * x),
         {"x": ((0.0, 300.0), -20.0, 20.0)}, "abs", 1e-14, S),
        ("suq_sin", lambda x: pm.suq_sin(x, 2.5),
         lambda x: np.sign(np.sin(x)) * np.abs(np.sin(x)) ** 2.5,
         {"x": ((0.0,), -10.0, 10.0)}, "abs", 1e-14, S),
        ("suq_cos", lambda x: pm.suq_cos(x, 2.5),
         lambda x: np.sign(np.cos(x)) * np.abs(np.cos(x)) ** 2.5,
         {"x": ((0.0,), -10.0, 10.0)}, "abs", 1e-14, S),
        ("modulo", lambda x: pm.modulo(x, 1.5), lambda x: np.fmod(x, 1.5),
         {"x": ((-5.5, 5.5, 0.0), -100.0, 100.0)}, "abs", 0.0, S),
        ("neg_one_pow_n", lambda x: pm.neg_one_pow_n(torch.round(x)),
         lambda x: np.where(np.round(x) % 2 == 0, 1.0, -1.0),
         {"x": ((0.0, 1.0, -3.0), -1000.0, 1000.0)}, "abs", 0.0, S),
        ("elliptic_f", pm.elliptic_f, ss.ellipkinc,
         {"phi": ((np.pi / 2, 0.0, 1.0), 0.0, np.pi / 2),
          "m": ((1.0, 0.5, 0.9), 0.0, 0.999)}, "rel", 1e-13, S),
        ("elliptic_e", pm.elliptic_e, ss.ellipeinc,
         {"phi": ((np.pi / 2, 0.0, 1.0), 0.0, np.pi / 2),
          "m": ((1.0, 0.5, 0.9), 0.0, 1.0)}, "rel", 1e-13, S),
        ("elliptic_pi", pm.elliptic_pi, pi_ref,
         {"n": ((0.3, -0.5, 0.0), -1.0, 0.9),
          "phi": ((1.0, 0.7, np.pi / 2), 0.0, np.pi / 2),
          "m": ((0.5, 0.9, 0.0), 0.0, 0.999)}, "rel", 1e-13, S),
        ("carlson_rf", pm.carlson_rf, ss.elliprf,
         {"x": ((0.0,), 0.0, 3.0), "y": ((1.0,), 0.01, 3.0),
          "z": ((2.0,), 0.01, 3.0)}, "rel", 1e-13, S),
        ("carlson_rd", pm.carlson_rd, ss.elliprd,
         {"x": ((0.0,), 0.0, 3.0), "y": ((1.0,), 0.01, 3.0),
          "z": ((2.0,), 0.01, 3.0)}, "rel", 1e-13, S),
        ("carlson_rj", pm.carlson_rj, ss.elliprj,
         {"x": ((0.0,), 0.0, 3.0), "y": ((1.0,), 0.01, 3.0),
          "z": ((2.0,), 0.01, 3.0), "p": ((0.5,), 0.01, 3.0)}, "rel", 1e-13,
         S),
        ("carlson_rc", pm.carlson_rc, ss.elliprc,
         {"x": ((0.0,), 0.0, 3.0), "y": ((1.0,), 0.01, 3.0)}, "rel", 1e-13,
         S),
    ]
    # the derivatives away from |x| = 1: the reference's formulas divide by
    # 1 - x^2 (its ODEs), losing digits as |x| -> 1 (1e-4 absolute for
    # U5'' at 1 - |x| = 3e-6), and take the limits at +-1 exactly
    inner = ((-1.0, 0.0, 1.0), -0.99, 0.99)
    for n in (5, 10):
        for d, suf in ((0, ""), (1, "_deriv1"), (2, "_deriv2")):
            tol = (1e-12, 1e-10, 1e-9)[d]
            dom = {"x": unit if d == 0 else inner}
            specs.append((f"chebyshev_tn{suf}({n})",
                          (lambda f, n: lambda x: f(n, x))(
                              getattr(pm, f"chebyshev_tn{suf}"), n),
                          cheb("T", n, d), dom, "abs",
                          tol * n ** (2 * d) / 25 ** d, S))
            specs.append((f"chebyshev_un{suf}({n})",
                          (lambda f, n: lambda x: f(n, x))(
                              getattr(pm, f"chebyshev_un{suf}"), n),
                          cheb("U", n, d), dom, "abs",
                          tol * n ** (2 * d) / 25 ** d, S))
            specs.append((f"legendre_pn{suf}({n})",
                          (lambda f, n: lambda x: f(n, x))(
                              getattr(pm, f"legendre_pn{suf}"), n),
                          leg(n, d), dom, "abs",
                          tol * n ** (2 * d) / 25 ** d, S))
    return specs


def lab_compare(kind, got, want, tol):
    """Largest deviation under ``kind``; NaN and inf must sit where the
    oracle has them."""
    got, want = np.asarray(got), np.asarray(want)
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError("NaN where the oracle has none, or none where "
                             "it has one")
    fin = np.isfinite(want)
    if not np.array_equal(got[~fin & ~np.isnan(want)],
                          want[~fin & ~np.isnan(want)]):
        raise AssertionError("infinities differ")
    d = np.abs(got[fin] - want[fin])
    if kind == "rel1":
        d = d / np.maximum(np.abs(want[fin]), 1.0)
    elif kind == "rel":
        d = d / np.maximum(np.abs(want[fin]), 1e-300)
    err = float(d.max()) if d.size else 0.0
    return lab_check(kind, err, tol)


def lab_special():
    """Every elementwise public function of ``math`` on LAB_POINTS seeded
    points on the card (edge values first): the finite share, every
    stride-th point and all edges against scipy on the host, the first
    LAB_CPU_POINTS against the port's CPU run; points/s and device launches
    of one call of bessel_jn(50), bessel_in(50) and elliptic_pi."""
    out, failed = {}, []
    specs = lab_special_specs()
    for i, (name, fn, ref, ins, kind, tol, stride) in enumerate(specs):
        host = [lab_inputs(e, lo, hi, SEED + 17 * i + j)
                for j, (e, lo, hi) in enumerate(ins.values())]
        dev = [torch.as_tensor(h, device="cuda") for h in host]
        got, wall, dev_ms = lab_timed(lambda: fn(*dev))
        if got.shape != (LAB_POINTS,) or got.device != dev[0].device:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} on "
                                 f"{got.device}")
        n_edges = max(len(e) for e, _, _ in ins.values())
        idx = np.unique(np.concatenate([np.arange(n_edges),
                                        np.arange(0, LAB_POINTS, stride)]))
        sub = got[torch.as_tensor(idx, device="cuda")].cpu().numpy()
        cpu = fn(*(torch.as_tensor(h[:LAB_CPU_POINTS]) for h in host))
        err = cpu_err = None
        try:
            err = lab_compare(kind, sub, ref(*(h[idx] for h in host)), tol)
            # the card against the CPU at the same bound (or LAB_CPU_TOL):
            # their sin, cos, log and exp differ in the last bits
            cpu_err = lab_compare(kind, got[:LAB_CPU_POINTS].cpu().numpy(),
                                  cpu.numpy(), LAB_CPU_TOL.get(name, tol))
        except AssertionError as e:
            failed.append(f"{name}: {e}")
        out[name] = {"max_err": err, "kind": kind, "tol": tol,
                     "checked": len(idx), "cpu_max_err": cpu_err,
                     "finite_share": float(torch.isfinite(got).double()
                                           .mean()),
                     "device_ms": dev_ms, "wall_s": wall}
        del dev, got
    if failed:
        raise AssertionError("lab_path special functions: "
                             + "; ".join(failed))
    for name in ("bessel_jn(50)", "bessel_in(50)", "elliptic_pi"):
        spec = next(s for s in specs if s[0] == name)
        dev = [torch.as_tensor(lab_inputs(e, lo, hi, SEED), device="cuda")
               for e, lo, hi in spec[3].values()]
        ms_by, wall, launches = kernel_device_ms(lambda: spec[1](*dev))
        dms = sum(ms_by.values())
        out[name].update(launches_a_call=launches, profiled_device_ms=dms,
                         points_per_s=LAB_POINTS / (out[name]["device_ms"]
                                                    / 1e3),
                         device_points_per_s=LAB_POINTS / (dms / 1e3),
                         busy=dms / (wall * 1e3))
    torch.cuda.empty_cache()
    return out


def lab_algo():
    """NewtonSolver on A u + u^3 - b (A SPD) on the card: at n 64 its
    counters and u against the CPU run, at n 2048 u against a numpy Newton
    oracle; InterpChebyshev.adapt_function then eval on LAB_POINTS points
    against its CPU eval; RootFinder, MinSolver and Quadrature (host work)
    against the reference's counters."""
    import math as pymath
    from russell_tpu_torch import algo
    out = {}
    for n in NEWTON_N:
        rng = np.random.default_rng(n)
        g = rng.standard_normal((n, n))
        a = g @ g.T / n + np.eye(n)
        b = rng.standard_normal(n)

        def run(dev):
            A, B = torch.as_tensor(a, device=dev), torch.as_tensor(b,
                                                                  device=dev)
            solver = algo.NewtonSolver(n)
            u = solver.solve(np.zeros(n), lambda x, u, _: A @ u + u ** 3 - B,
                             device=dev)
            st = solver.stats
            return u, (st.n_function, st.n_jacobian, st.n_iterations)

        (u, cnt), wall, dev_ms = lab_timed(lambda: run("cuda"))
        if u.device.type != "cuda":
            raise AssertionError("NewtonSolver: u left the card")
        rec = {"counters": cnt, "wall_s": wall, "device_ms": dev_ms}
        if n == NEWTON_N[0]:
            uc, cc = run("cpu")
            if cc != cnt:
                raise AssertionError(f"NewtonSolver n {n}: counters {cnt} "
                                     f"on the card, {cc} on the CPU")
            rec["u_max_abs_diff_cpu"] = lab_check(
                "newton cpu", float((u.cpu() - uc).abs().max()), 1e-12)
        else:
            v, its = np.zeros(n), 0
            while True:
                its += 1
                r = a @ v + v ** 3 - b
                if np.sqrt(np.sum((r / (1e-10 + 1e-10 * np.abs(v))) ** 2)
                           / n) < 1:
                    break
                v = v + np.linalg.solve(a + np.diag(3 * v * v), -r)
            rec["oracle_iterations"] = its
            rec["u_max_abs_diff_oracle"] = lab_check(
                "newton oracle", float(np.abs(u.cpu().numpy() - v).max()),
                1e-10)
        out[f"newton_{n}"] = rec
    f = lambda x, _: pymath.cos(3.0 * x) * pymath.exp(-0.1 * x)  # noqa: E731
    interp = algo.InterpChebyshev(200, 0.0, 20.0)
    t0 = time.perf_counter()
    interp.adapt_function(1e-10, f)
    adapt_s = time.perf_counter() - t0
    xs = torch.as_tensor(lab_inputs((0.0, 20.0, -1.0, 21.0), 0.0, 20.0,
                                    SEED), device="cuda")
    got, wall, dev_ms = lab_timed(lambda: interp.eval(xs))
    want = interp.eval(xs.cpu())
    out["interp_chebyshev"] = {
        "degree": interp.get_degree(), "adapt_s": adapt_s,
        "eval_device_ms": dev_ms, "eval_wall_s": wall,
        "points_per_s": LAB_POINTS / (dev_ms / 1e3) if dev_ms else None,
        "max_abs_diff_cpu": lab_check("interp eval", float(
            (got.cpu() - want).abs().max()), 1e-13),
        "max_abs_err_f": lab_check("interp f", float(np.abs(
            got[:4096].cpu().numpy() - np.array([f(x, None) for x in xs[:4096]
                                                 .cpu().numpy().clip(0, 20)])
        ).max()), 1e-9)}
    g4 = lambda x, a: x ** 4 - 1.0  # noqa: E731
    solver = algo.RootFinder().set_enable_stats(True)
    t0 = time.perf_counter()
    roots = solver.chebyshev(algo.InterpChebyshev(2, -2.0, 2.0)
                             .set_function(2, g4))
    solver.refine(roots, -2.0, 2.0, g4)
    root = solver.brent(2.0, 4.0, lambda x, a: pymath.sin(x))
    st = solver.stats
    cnt = (st.n_function, st.n_jacobian, st.n_iterations)
    lab_counters("RootFinder", cnt, LAB_ROOT_COUNTERS)
    out["root_finder"] = {"counters": cnt, "roots": roots, "brent": root,
                          "host_s": time.perf_counter() - t0}
    h = lambda x, a: (x - 2.0) ** 2 + 1.0 + 0.1 * pymath.sin(5 * x)  # noqa
    br = algo.MinBracketing().set_enable_stats(True)
    bk = br.basic(0.0, h)
    ms = algo.MinSolver().set_enable_stats(True)
    xmin = ms.brent(bk.a, bk.c, h)
    cnt = ((br.stats.n_function, br.stats.n_iterations),
           (ms.stats.n_function, ms.stats.n_iterations))
    lab_counters("MinSolver", cnt, LAB_MIN_COUNTERS)
    out["min_solver"] = {"counters": cnt, "x_min": xmin}
    q = algo.Quadrature().set_enable_stats(True)
    v = q.integrate(-1.0, 1.0, lambda x, a: pymath.sqrt(1.0 - x * x))
    cnt = (q.stats.n_function, q.stats.n_iterations)
    lab_counters("Quadrature", cnt, LAB_QUAD_COUNTERS)
    out["quadrature"] = {"counters": cnt, "value": v,
                         "err": lab_check("quadrature", abs(v - pymath.pi
                                                            / 2), 1e-9)}
    return out


def phase_lab_path():
    """Phase 24: core, math, dense and algo at the sizes their users run
    (the module docstring's item 24). Returns the records; the kernels line
    takes the Jacobi one."""
    t0 = time.perf_counter()
    res = {"dense": lab_dense()}
    say("lab_path", part="dense", **res["dense"])
    res["jacobi"] = lab_jacobi()
    say("lab_path", part="jacobi",
        **{k: v for k, v in res["jacobi"].items() if k != "at_n"},
        at_n={str(k): v for k, v in res["jacobi"]["at_n"].items()})
    res["special"] = lab_special()
    say("lab_path", part="special", functions=res["special"])
    res["algo"] = lab_algo()
    say("lab_path", part="algo", **res["algo"])
    say("lab_path", part="done", wall_s=time.perf_counter() - t0)
    return res


def jacobi_entry(lres):
    """The kernels line's jacobi_eig entry: at the largest n held bit for
    bit (time, plain version's time, bound, eigh's time), and at JACOBI_N."""
    j = lres["jacobi"]
    s = j["small"]
    return {"name": "jacobi_eig", "route": "cuda",
            "kernel_route": s["route"], "ctas": s["ctas"],
            "source": "russell_tpu_torch/csrc/jacobi_eig.cu",
            "replaces": "russell_tpu/dense/matrix_ops.py:148 (plain XLA)",
            "launches": j["launches"],
            "max_abs_err": max(h["max_abs_err"] for h in j["held_to_plain"]),
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"], "ns_per_round": s["ns_per_round"],
            "held_to_plain": j["held_to_plain"],
            "at_n": {str(k): v for k, v in j["at_n"].items()},
            "shapes": f"n {s['n']} (held bit for bit; plain_ms one call of "
                      "the plain version on the card); at_n: the "
                      "lab_path's mat_eigen_sym_jacobi calls"}


def pde_entry(pres, name):
    """A kernel's launches in pde_path: per GRIDMF factorization at
    PDE_NPOINT (gj_inv only, with the held-to-plain record of one such
    factorization), over a SPLU solve_sps at PDE_SPLU_NPOINT and the
    held-to-plain record of the second one."""
    g = pres[f"gridmf_{PDE_NPOINT}"]
    sp = pres[f"splu_{PDE_SPLU_NPOINT}"]
    out = {}
    if name == "gj_inv":
        out.update(gridmf_launches_per_factorization=g[
            "launches_cold_factorization"]["gj_inv"],
            gridmf_ms_per_factorization=g["gj_inv_device_ms"],
            gridmf_held_to_plain=g["held_to_plain"]["gj_inv"])
    out.update(splu_launches_solve_sps=sp["launches_solve_sps"][name],
               splu_held_to_plain=sp["held_to_plain"][name])
    return out


# -- phase 25: stat_tensor_path ----------------------------------------------

ST_DRAWS = 1 << 26        # f64 draws a distribution: 512 MiB
ST_KS_N = 1 << 20         # the first draws, held by the KS statistic
ST_POINTS = 1 << 24       # pdf and cdf points: 128 MiB a tensor
ST_HOST_N = 1 << 22       # quartiles, outliers and Histogram: the first draws
ST_SE = 6.0               # sample moments within this many standard errors
ST_KS_C = 1.95            # the KS bound 1.95 / sqrt(n) (alpha ~ 0.001)
ST_PDF_RTOL = 1e-13
# pdf/cdf points span the quantiles [q, 1 - q]: 0.5 (1 + erf) keeps 1e-13
# of the cdf's value above it (erf's ulps over 2 q)
ST_PDF_Q = 0.01
ST_BINS = 20
ST_REPS = 5
TENSOR_N = 1 << 22        # symmetric tensors (Mandel 6): ~4 M Gauss points
TENSOR_SUBSET = 4096      # held to the port's per-point calls on the CPU
TENSOR_RTOL = 1e-12
TENSOR_GAP = 1e-6         # projectors held where the eigen gap > this |T|
TENSOR_CPU_WORKERS = 4
TENSOR_REPS = 3           # vmapped calls timed back to back (time_ms)
SPECTRAL_3D_N = 256       # 3-D Spectral2 one call at a time on the card
# torch.func.vmap's chunk for Spectral2: torch.linalg.eigh's batched
# cuSOLVER route (cusolverDnXsyevBatched) refuses batches of 3x3 f64
# matrices from between 28,672 and 32,766 up (INVALID_VALUE; an H100,
# torch 2.11+cu128)
SPECTRAL_CHUNK = 1 << 14
CHECKPOINT_EVERY = 10
# the invariants of a Tensor2, and each one's degree in |T| (its scale)
TENSOR_INVARIANTS = (("trace", 1), ("invariant_ii2", 2), ("invariant_ii3", 3),
                     ("invariant_jj2", 2), ("invariant_jj3", 3),
                     ("invariant_sigma_m", 1), ("invariant_sigma_d", 1),
                     ("invariant_eps_d", 1), ("invariant_lode", 0),
                     ("octahedral_distance", 1), ("octahedral_radius", 1))
# Stats.summary's lines -> the Stats fields
SUMMARY_COUNTERS = {
    "function evaluations": "n_function", "Jacobian evaluations": "n_jacobian",
    "factorizations": "n_factor", "lin sys solutions": "n_lin_sol",
    "performed steps": "n_steps", "accepted steps": "n_accepted",
    "rejected steps": "n_rejected", "iterations (maximum)": "n_iterations_max",
    "iterations (last step)": "n_iterations"}


def cli_report(text):
    """What an ODE CLI of either package printed: the Radau5 counters of
    ``Stats.summary`` (named as the Stats fields), ``h_accepted``, the
    printed y, the brusselator_pde header line and its ``finite`` flag."""
    rep = {"counters": {}, "y": [], "head": None, "finite": None,
           "h_accepted": None, "wall_s": None}
    for line in text.splitlines():
        key, _, val = (s.strip() for s in line.partition("="))
        if key.startswith("Number of "):
            rep["counters"][SUMMARY_COUNTERS[key[len("Number of "):]]] = \
                int(val)
        elif key == "Last accepted/suggested stepsize":
            rep["h_accepted"] = float(val)
        elif key.startswith("y["):
            rep["y"].append(float(val))
        elif key == "finite":
            rep["finite"] = val == "True"
        elif key == "total wall time":
            rep["wall_s"] = float(val.split()[0])
        elif line.startswith("brusselator_pde:"):
            rep["head"] = line
    return rep


def fourth_central(d):
    """The fourth central moment of distribution ``d`` (either package's)."""
    name = type(d).__name__
    var = d.variance()
    if name == "DistributionNormal":
        return 3.0 * var ** 2
    if name == "DistributionUniform":
        return (d.xmax - d.xmin) ** 4 / 80.0
    if name == "DistributionGumbel":
        return 5.4 * var ** 2
    if name == "DistributionLognormal":
        s2 = d.sig ** 2
        return (math.exp(4 * s2) + 2 * math.exp(3 * s2)
                + 3 * math.exp(2 * s2) - 3.0) * var ** 2
    g = [math.gamma(1.0 - k / d.shape) for k in range(5)]
    return d.scale ** 4 * (g[4] - 4 * g[3] * g[1] + 6 * g[2] * g[1] ** 2
                           - 3 * g[1] ** 4)


def st_distributions():
    """(name, the port's distribution, scipy's) of the phase: parameters
    with a fourth moment (Frechet shape 6)."""
    from scipy import stats as ss
    from russell_tpu_torch import stat
    return (("frechet", stat.DistributionFrechet(8.782275, 1.0, 6.0),
             ss.invweibull(6.0, loc=8.782275, scale=1.0)),
            ("gumbel", stat.DistributionGumbel(1.0, 2.0),
             ss.gumbel_r(1.0, 2.0)),
            ("lognormal", stat.DistributionLognormal(0.5, 0.25),
             ss.lognorm(0.25, scale=math.exp(0.5))),
            ("normal", stat.DistributionNormal(2.0, 3.0), ss.norm(2.0, 3.0)),
            ("uniform", stat.DistributionUniform(1.0, 3.0),
             ss.uniform(1.0, 2.0)))


def ks_statistic(d, draws):
    """The KS statistic of ``draws`` against ``d.cdf``, on their device."""
    u = d.cdf(torch.sort(draws).values)
    n = draws.numel()
    i = torch.arange(1, n + 1, dtype=torch.float64, device=draws.device)
    return float(torch.maximum((i / n - u).max(), (u - (i - 1) / n).max()))


def st_host(d, sd, xh):
    """Statistics on all copied draws, quartiles, outliers and a
    ST_BINS-bin Histogram on the first ST_HOST_N, each held to numpy."""
    from russell_tpu_torch import stat
    rec = {}
    t = time.perf_counter()
    st = stat.Statistics(xh)
    rec["statistics_s"] = time.perf_counter() - t
    std = float(np.std(xh, ddof=1))
    if (st.min != float(xh.min()) or st.max != float(xh.max())
            or st.mean != float(np.mean(xh))
            or abs(st.std_dev - std) > 1e-12 * std):
        raise AssertionError(f"Statistics {st} off numpy's (std {std})")
    x = xh[:ST_HOST_N]
    t = time.perf_counter()
    q = stat.quartiles(x)
    out = stat.outliers(x)
    h = stat.Histogram(np.linspace(sd.ppf(ST_PDF_Q), sd.ppf(1 - ST_PDF_Q),
                                   ST_BINS + 1))
    h.count(x)
    text = h.draw()
    rec["host_s"] = time.perf_counter() - t
    nq = np.quantile(x, [0.25, 0.5, 0.75])
    lo = nq[0] - 1.5 * (nq[2] - nq[0])
    hi = nq[2] + 1.5 * (nq[2] - nq[0])
    s = h.stations
    want = np.histogram(x[(x >= s[0]) & (x < s[-1])], s)[0]
    idx = np.array([i for i, _ in out], dtype=np.int64)
    vals = np.array([v for _, v in out])
    if (np.abs(np.array(q) - nq).max() > 1e-12 * max(np.abs(nq).max(), 1.0)
            or len(out) != int(np.count_nonzero((x < lo) | (x > hi)))
            or not np.array_equal(x[idx], vals)
            or not np.all(np.diff(vals) >= 0)
            or not np.array_equal(h.get_counts(), want)
            or len(text.splitlines()) != ST_BINS):
        raise AssertionError("quartiles, outliers or Histogram off numpy's")
    rec.update(quartiles=list(q), n_outliers=len(out))
    return rec


def launch_count(fn, tries=3):
    """The device launches of one call of ``fn`` under the profiler, which
    now and then reports none for a call: retried up to ``tries`` times
    while it reads 0. Late in a whole smoke it also reports some calls'
    events only in part; the ``--stat-tensor`` run alone gives whole
    counts."""
    for _ in range(tries):
        n = kernel_device_ms(fn)[2]
        if n:
            return n
    return n


def st_distribution(i, name, d, sd):
    """One distribution of the phase (the module docstring's item 25)."""
    n = ST_DRAWS
    g = torch.Generator("cuda")
    g.manual_seed(SEED + i)
    torch.cuda.synchronize()
    t = time.perf_counter()
    x = d.sample(g, n)
    torch.cuda.synchronize()
    rec = {"distribution": name, "draws": n,
           "first_draw_wall_s": time.perf_counter() - t}
    if x.dtype != torch.float64 or x.shape != (n,) or x.device.type != "cuda":
        raise AssertionError(f"{name}: draws {x.dtype} {x.shape} {x.device}")
    g.manual_seed(SEED + i)
    same = bool(torch.equal(d.sample(g, n), x))
    mean, var = float(x.mean()), float(x.var())
    mu, sig2 = d.mean(), d.variance()
    mean_z = (mean - mu) / np.sqrt(sig2 / n)
    var_z = (var - sig2) / np.sqrt((fourth_central(d) - sig2 ** 2) / n)
    ks = ks_statistic(d, x[:ST_KS_N])
    pts = torch.linspace(sd.ppf(ST_PDF_Q), sd.ppf(1 - ST_PDF_Q), ST_POINTS,
                         dtype=torch.float64, device="cuda")
    ph = pts.cpu().numpy()
    errs = {}
    for f in ("pdf", "cdf"):
        got = getattr(d, f)(pts).cpu().numpy()
        want = getattr(sd, f)(ph)
        errs[f] = float(np.max(np.abs(got - want) / np.abs(want)))
    sample_ms = time_ms(lambda: d.sample(g, n), reps=ST_REPS)
    pdf_ms = time_ms(lambda: d.pdf(pts), reps=ST_REPS)
    cdf_ms = time_ms(lambda: d.cdf(pts), reps=ST_REPS)
    launches = {f: launch_count(fn) for f, fn in (
        ("sample", lambda: d.sample(g, n)), ("pdf", lambda: d.pdf(pts)),
        ("cdf", lambda: d.cdf(pts)))}
    t = time.perf_counter()
    xh = x.cpu().numpy()
    rec["copy_s"] = time.perf_counter() - t
    rec.update(same_seed_bit_identical=same, mean=mean, variance=var,
               mean_z=mean_z, variance_z=var_z, ks=ks,
               ks_bound=ST_KS_C / np.sqrt(ST_KS_N),
               pdf_max_rel_err=errs["pdf"], cdf_max_rel_err=errs["cdf"],
               sample_ms=sample_ms, draws_per_s=n / sample_ms * 1e3,
               pdf_ms=pdf_ms, cdf_ms=cdf_ms,
               pdf_points_per_s=ST_POINTS / pdf_ms * 1e3,
               cdf_points_per_s=ST_POINTS / cdf_ms * 1e3,
               launches_a_call=launches)
    del x, pts
    rec.update(st_host(d, sd, xh))
    say("stat_tensor_path", part="stat", **rec)
    if not (same and abs(mean_z) < ST_SE and abs(var_z) < ST_SE
            and ks < rec["ks_bound"] and errs["pdf"] <= ST_PDF_RTOL
            and errs["cdf"] <= ST_PDF_RTOL):
        raise AssertionError(f"{name}: draws or pdf/cdf off: {rec}")
    return rec


def tensor_fns(dev):
    """The phase's tensor functions of one Mandel-6 vector x on ``dev``,
    each returning one tensor: LinElasticity.calc_stress, the invariants
    (stacked), deriv1_invariant_lode, deriv2_invariant_jj3,
    deriv_inverse_tensor, and Spectral2(two_dim=True) of x's Mandel-4
    slice (eigenvalues, then the three projectors)."""
    from russell_tpu_torch import tensor as pt
    le = pt.LinElasticity(210e3, 0.3, device=dev)
    m6, m4 = pt.Mandel.SYMMETRIC, pt.Mandel.SYMMETRIC_2D

    def spectral_2d(x):
        sp = pt.Spectral2(True, dev).decompose(pt.Tensor2(m4, x[:4]))
        return torch.cat([sp.lambdas] + [p.vec for p in sp.projectors])

    return {
        "calc_stress": lambda x: le.calc_stress(pt.Tensor2(m6, x)).vec,
        "invariants": lambda x: torch.stack([
            getattr(pt.Tensor2(m6, x), f)() for f, _ in TENSOR_INVARIANTS]),
        "deriv1_invariant_lode": lambda x: pt.deriv1_invariant_lode(
            pt.Tensor2(m6, x)).vec,
        "deriv2_invariant_jj3": lambda x: pt.deriv2_invariant_jj3(
            pt.Tensor2(m6, x)).mat,
        "deriv_inverse_tensor": lambda x: pt.deriv_inverse_tensor(
            pt.Tensor2(m6, x)).mat,
        "spectral2_2d": spectral_2d,
    }


def t4_ddot_t4_fn(a, b):
    from russell_tpu_torch import tensor as pt
    m6 = pt.Mandel.SYMMETRIC
    return pt.t4_ddot_t4(1.0, pt.Tensor4(m6, a), pt.Tensor4(m6, b)).mat


def spectral_3d(x, dev):
    """Spectral2 (3-D) of one Mandel-6 vector: eigenvalues and projectors."""
    from russell_tpu_torch import tensor as pt
    sp = pt.Spectral2(device=dev).decompose(pt.Tensor2(pt.Mandel.SYMMETRIC,
                                                       x))
    return torch.cat([sp.lambdas] + [p.vec for p in sp.projectors])


def tensor_cpu_points(xs):
    """The port's per-point CPU calls of the phase's tensor functions on the
    rows of ``xs`` (numpy), one thread: {name: stacked numpy results}, with
    t4_ddot_t4 of each point's deriv2_invariant_jj3 and
    deriv_inverse_tensor, and the 3-D Spectral2 of the rows below
    SPECTRAL_3D_N (every row: the caller keeps the first). Run in worker
    processes beside the card's work."""
    torch.set_num_threads(1)
    fns = tensor_fns("cpu")
    out = {k: [] for k in (*fns, "t4_ddot_t4", "spectral2_3d")}
    for r, x in enumerate(torch.as_tensor(xs)):
        res = {k: f(x) for k, f in fns.items()}
        res["t4_ddot_t4"] = t4_ddot_t4_fn(res["deriv2_invariant_jj3"],
                                          res["deriv_inverse_tensor"])
        for k, v in res.items():
            out[k].append(v.numpy())
        out["spectral2_3d"].append(spectral_3d(x, "cpu").numpy())
    return {k: np.stack(v) for k, v in out.items()}


def tensor_held(name, got, want, xs):
    """The largest error of ``got`` (card, the subset's rows) against
    ``want`` (the per-point CPU calls) over the subset, each point's
    relative to its result's largest entry; for the invariants, each
    relative to |T|^degree; for the eigen results, to |T| (the projectors'
    entries to 1) where each eigenvalue's gap to the others exceeds
    TENSOR_GAP |T|. Raises above TENSOR_RTOL."""
    norm = np.linalg.norm(xs[:, :4] if name == "spectral2_2d" else xs,
                          axis=1)
    got = got.reshape(len(xs), -1)
    want = want.reshape(len(xs), -1)
    if name == "invariants":
        deg = np.array([p for _, p in TENSOR_INVARIANTS])
        scale = norm[:, None] ** deg[None, :]
    elif name.startswith("spectral2"):
        lam = want[:, :3]
        gap = np.stack([np.min(np.abs(lam[:, [j]] - lam[:, [k for k in range(
            3) if k != j]]), axis=1) for j in range(3)], axis=1)
        ok = gap > TENSOR_GAP * norm[:, None]
        dim = (want.shape[1] - 3) // 3
        keep = np.concatenate([np.ones((len(xs), 3), bool),
                               np.repeat(ok, dim, axis=1)], axis=1)
        scale = np.concatenate([np.repeat(norm[:, None], 3, axis=1),
                                np.ones((len(xs), 3 * dim))], axis=1)
        got, want = np.where(keep, got, 0.0), np.where(keep, want, 0.0)
    else:
        scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-300)
    err = float(np.max(np.abs(got - want) / scale))
    if not err <= TENSOR_RTOL:
        raise AssertionError(f"{name}: the card's vmapped results are "
                             f"{err} off the per-point CPU calls")
    return err


def tensor_inputs():
    """TENSOR_N seeded symmetric tensors (Mandel 6) on the card, the sorted
    seeded subset's indices and its rows on the host."""
    g = torch.Generator("cuda")
    g.manual_seed(SEED)
    V = torch.randn((TENSOR_N, 6), generator=g, dtype=torch.float64,
                    device="cuda")
    idx = np.sort(np.random.default_rng(SEED).choice(TENSOR_N, TENSOR_SUBSET,
                                                     replace=False))
    return V, idx, V[torch.as_tensor(idx, device="cuda")].cpu().numpy()


def tensor_part(V, idx, xs, cpu):
    """``V`` through torch.func.vmap on the card, each result held on the
    subset ``idx`` (rows ``xs``) to the port's per-point CPU calls
    (``cpu``, an AsyncResult of tensor_cpu_points over chunks of ``xs``);
    then 3-D Spectral2 one call at a time."""
    fns = tensor_fns("cuda")
    recs, outs = {}, {}

    def run(name, fn, *args):
        vfn = torch.func.vmap(fn, chunk_size=(
            SPECTRAL_CHUNK if name == "spectral2_2d" else None))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out = vfn(*args)
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - base
        del out
        device_ms = time_ms(lambda: vfn(*args), reps=TENSOR_REPS, warmup=1)
        launches = launch_count(lambda: vfn(*args))
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs[name] = vfn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        recs[name] = {"first_wall_s": first, "wall_s": wall,
                      "device_ms": device_ms, "launches": launches,
                      "points_per_s": TENSOR_N / device_ms * 1e3,
                      "points_per_s_wall": TENSOR_N / wall,
                      "peak_bytes_above_inputs": peak,
                      "out_bytes": outs[name].numel() * 8}

    for name, fn in fns.items():
        run(name, fn, V)
    run("t4_ddot_t4", t4_ddot_t4_fn, outs["deriv2_invariant_jj3"],
        outs["deriv_inverse_tensor"])
    # 3-D Spectral2 reads the device in from_matrix: one call at a time
    rows = V[torch.as_tensor(idx[:SPECTRAL_3D_N], device="cuda")]
    spectral_3d(rows[0], "cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    s3 = torch.stack([spectral_3d(x, "cuda") for x in rows])
    torch.cuda.synchronize()
    s3_wall = time.perf_counter() - t
    s3_launches = launch_count(lambda: spectral_3d(rows[0], "cuda"))
    t = time.perf_counter()
    parts = cpu.get()
    wait_s = time.perf_counter() - t
    want = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    sel = torch.as_tensor(idx, device="cuda")
    for name, out in outs.items():
        recs[name]["max_rel_err_vs_cpu"] = tensor_held(
            name, out[sel].cpu().numpy(), want[name], xs)
    recs["spectral2_3d"] = {
        "calls": SPECTRAL_3D_N, "wall_s": s3_wall,
        "calls_per_s": SPECTRAL_3D_N / s3_wall, "launches": s3_launches,
        "max_rel_err_vs_cpu": tensor_held(
            "spectral2_3d", s3.cpu().numpy(),
            want["spectral2_3d"][:SPECTRAL_3D_N], xs[:SPECTRAL_3D_N])}
    del outs
    torch.cuda.empty_cache()
    for name, rec in recs.items():
        say("stat_tensor_path", part="tensor", function=name, points=(
            TENSOR_N if name != "spectral2_3d" else SPECTRAL_3D_N), **rec)
    return {"functions": recs, "cpu_wait_s": wait_s}


def run_cli(main, argv):
    """``main(argv)`` with its standard output captured: (rc, text, wall)."""
    import io
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t


def gridmf_129_counters():
    """The fused GRIDMF-129 run's counters, as phase 20 records them."""
    from russell_tpu_torch.ode import Method, Params, samples
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT)
    params = Params(Method.RADAU5)
    params.set_tolerances(1e-4, 1e-4)
    return fused_runs(params, system, y0, t0, 1.0, 0)[0]["counters"]


def cli_part(gridmf_counters):
    """The three CLIs on the card, a checkpointed van der Pol run and a
    trace of a warm GRIDMF factorize pair."""
    from russell_tpu_torch.bin import amplifier1t, brusselator_pde, mem_check
    from russell_tpu_torch.ode import (Method, OdeSolver, Output, Params,
                                       samples)
    from russell_tpu_torch.sparse import factor
    from russell_tpu_torch.utils import CheckpointManager, trace
    res = {}
    reset_launch_counts()
    rc, text, wall = run_cli(brusselator_pde.main, [])
    rep = cli_report(text)
    res["brusselator_pde"] = {
        "rc": rc, "wall_s": wall, "integration_wall_s": rep["wall_s"],
        "counters": rep["counters"], "y0": rep["y"][0],
        "finite": rep["finite"], "gj_inv_launches": gj_inv_launches()}
    say("stat_tensor_path", part="cli", cli="brusselator_pde",
        **res["brusselator_pde"])
    if (rc != 0 or rep["counters"] != gridmf_counters or not rep["finite"]
            or gj_inv_launches() <= 0):
        raise AssertionError(f"bin.brusselator_pde: {rep} (fused GRIDMF-129 "
                             f"counters {gridmf_counters})")
    rc, text, wall = run_cli(amplifier1t.main, [])
    rc_cpu, text_cpu, wall_cpu = run_cli(amplifier1t.main,
                                         ["--device", "cpu"])
    rep, rep_cpu = cli_report(text), cli_report(text_cpu)
    y_err = float(np.max(np.abs(np.array(rep["y"]) - rep_cpu["y"])
                         / np.abs(rep_cpu["y"])))
    res["amplifier1t"] = {"rc": rc, "wall_s": wall, "cpu_wall_s": wall_cpu,
                          "counters": rep["counters"],
                          "y_max_rel_diff_vs_cpu": y_err}
    say("stat_tensor_path", part="cli", cli="amplifier1t",
        **res["amplifier1t"])
    if rc != 0 or rc_cpu != 0 or rep["counters"] != rep_cpu["counters"]:
        raise AssertionError(f"bin.amplifier1t on the card {rep} != on the "
                             f"CPU {rep_cpu}")
    rc, text, wall = run_cli(mem_check.main, [])
    lines = [ln for ln in text.splitlines() if "requested=" in ln]
    res["mem_check"] = {"rc": rc, "wall_s": wall, "cases": len(lines),
                        "requested": [ln.split("requested=")[1]
                                      for ln in lines]}
    say("stat_tensor_path", part="cli", cli="mem_check", **res["mem_check"])
    if rc != 0 or len(lines) != 21:
        raise AssertionError(f"bin.mem_check on the card:\n{text}")
    # a checkpoint every CHECKPOINT_EVERY accepted steps of van der Pol
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "stat_tensor_path")
    ck = CheckpointManager(os.path.join(out_dir, "van_der_pol.npz"))
    inner = ck.as_step_callback(CHECKPOINT_EVERY)
    seen = []

    def cb(stats, h, x, y, args):
        seen.append((x, np.array(y), h))
        return inner(stats, h, x, y, args)

    system, x0, y0, x1, _ = samples.van_der_pol(1e-6, False)
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    t = time.perf_counter()
    OdeSolver(params, system, "cuda").solve(
        y0, x0, x1, output=Output().set_step_callback(cb))
    wall = time.perf_counter() - t
    x, y, h, meta = ck.load()
    last = seen[len(seen) // CHECKPOINT_EVERY * CHECKPOINT_EVERY - 1]
    same = x == last[0] and h == last[2] and np.array_equal(y, last[1])
    res["checkpoint"] = {"accepted_steps": len(seen), "wall_s": wall,
                         "snapshots": len(seen) // CHECKPOINT_EVERY,
                         "last_snapshot_x": x, "bit_identical": bool(same)}
    say("stat_tensor_path", part="checkpoint", **res["checkpoint"])
    if not same:
        raise AssertionError("checkpoint: the last snapshot is not the step's "
                             f"(x, y, h): {(x, y, h)} != {last}")
    # a trace around one warm GRIDMF-129 factorize pair
    plan, vr, vc, _ = gridmf_setup(NPOINT)
    factor.numeric_factorize_pair(plan, vr, vc)
    torch.cuda.synchronize()
    trace_dir = os.path.join(out_dir, "trace")
    if os.path.isdir(trace_dir):
        for f in os.listdir(trace_dir):
            os.remove(os.path.join(trace_dir, f))
    with trace(trace_dir) as prof:
        factor.numeric_factorize_pair(plan, vr, vc)
        torch.cuda.synchronize()
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    gj = [e for e in events if e.get("cat") == "kernel"
          and "gj_inv" in str(e.get("name"))]
    res["trace"] = {"files": len(files), "bytes": os.path.getsize(files[0]),
                    "gj_inv_kernel_events": len(gj),
                    "kernel_events": sum(e.get("cat") == "kernel"
                                         for e in events),
                    "profiler_device_ms": sum(
                        e.self_device_time_total
                        for e in prof.key_averages()) / 1e3}
    say("stat_tensor_path", part="trace", **res["trace"])
    if len(files) != 1 or not gj:
        raise AssertionError("trace: no gj_inv kernel in the trace file")
    return res


def phase_stat_tensor_path(gridmf_counters=None):
    """Phase 25: stat, tensor, the CLIs and utils on the card (the module
    docstring's item 25). ``gridmf_counters`` are phase 20's fused
    GRIDMF-129 counters (run here when None). Returns the records; the
    kernels line takes the CLI's gj_inv launches."""
    import multiprocessing
    t0 = time.perf_counter()
    if gridmf_counters is None:
        gridmf_counters = gridmf_129_counters()
    res = {}
    V, idx, xs = tensor_inputs()
    with multiprocessing.get_context("spawn").Pool(TENSOR_CPU_WORKERS) as pool:
        cpu = pool.map_async(tensor_cpu_points,
                             np.array_split(xs, TENSOR_CPU_WORKERS))
        res["stat"] = [st_distribution(i, *d)
                       for i, d in enumerate(st_distributions())]
        res["tensor"] = tensor_part(V, idx, xs, cpu)
    del V
    torch.cuda.empty_cache()
    res["cli"] = cli_part(gridmf_counters)
    say("stat_tensor_path", part="done", wall_s=time.perf_counter() - t0,
        tensor_cpu_wait_s=res["tensor"]["cpu_wait_s"])
    return res


# -- parallel_path -------------------------------------------------------------

PAR_RANKS = 4             # part (b): ranks on the one card, under gloo
PAR_RANK_TIMEOUT_S = 600  # part (b) fails when a rank runs longer
PAR_BATCH = 32            # systems of batch_factor_solve
PAR_FAC_TOL = 1e-12       # part (b): factors within this x (1 + max|.|)
PAR_RES_TOL = 1e-9        # part (b): absolute residual max|A x - b|
PAR_LOGDET_TOL = 1e-8     # part (b): log|det|
PAR_STATS = ("logdet", "min_pivot", "n_perturbed", "phase")
# host plans that two phases of one smoke share: lin_solver_path keeps its
# geometric_264k SolvePlan here for parallel_path
SHARED_PLANS: dict = {}


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def bit_equal(name, a, b):
    """Require ``a`` and ``b`` (tensors, numbers, None, or dicts and lists
    of them) to hold the same bits, dict keys of ``a`` only."""
    if isinstance(a, dict):
        for k, v in a.items():
            bit_equal(f"{name}.{k}", v, b[k])
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{name}: {len(a)} items against {len(b)}")
        for i, (u, v) in enumerate(zip(a, b)):
            bit_equal(f"{name}[{i}]", u, v)
    elif torch.is_tensor(a):
        if not (torch.is_tensor(b) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b)):
            raise AssertionError(f"{name}: not bit for bit equal")
    elif a != b:
        raise AssertionError(f"{name}: {a} != {b}")


def fac_stats(fac):
    return {k: fac[k] for k in PAR_STATS if k in fac}


def timed_run(fn, reps=None):
    """A first call of ``fn`` (its result kept; its wall, with the plan's
    uploads and caches, and the SPLU kernels' and gj_inv's launches
    counted from 0), then a warm one under the profiler: device ms summed
    over its kernels, device launches and its wall. With ``reps`` the
    device ms are ``time_ms``'s instead (CUDA events around ``reps`` calls
    back to back), for calls too short for the profiler to keep."""
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = kernel_counts()
    by_name, wall, events = kernel_device_ms(fn)
    device_ms = time_ms(fn, reps) if reps else sum(by_name.values())
    return out, {"first_call_s": first, "warm_wall_s": wall,
                 "device_ms": device_ms, "device_launches": events,
                 "launches": launches}


def par_world1_check(name, single, dist_fn, compare, smi, reps=None):
    """Part (a): ``dist_fn`` (the parallel call in the world of one) and
    ``single`` (the same call on one device), each timed (``timed_run``);
    ``compare`` holds them (bit for bit). Returns the record."""
    s_out, s_rec = timed_run(single, reps)
    d_out, d_rec = timed_run(dist_fn, reps)
    extra = compare(s_out, d_out) or {}
    del s_out, d_out
    torch.cuda.empty_cache()
    import torch.distributed as dist
    rec = {"check": name, "world": dist.get_world_size(),
           "backend": dist.get_backend(), "single": s_rec,
           "dist": d_rec, "bit_for_bit": True, "card": smi, **extra}
    say("parallel_path", part="world_1", **rec)
    return rec


def gridmf_fac_equal(name, gp, single, dist_):
    """Hold a split GRIDMF or GENMF fac to the single one bit for bit, one
    depth at a time, freeing the single one's depth after its check."""
    key = "levels" if "levels" in single else "classes"
    for d, (s, t) in enumerate(zip(single[key], dist_[key])):
        bit_equal(f"{name} {key}[{d}]", s, t)
        single[key][d] = None
    bit_equal(f"{name} stats", fac_stats(single), fac_stats(dist_))


def par_world1(smi):
    """Part (a): a world of one rank under NCCL in this process (a file
    store in a temporary directory), every call at full width held bit for
    bit to the same call on one device."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from russell_tpu_torch import parallel as par
    from russell_tpu_torch.sparse import (CsrMatrix, Genie, factor, genmf,
                                          gridmf, samples, splu)
    tmp = tempfile.mkdtemp(prefix="parallel_path_")
    recs = []
    par.initialize_multihost(init_method=f"file://{tmp}/store",
                             num_processes=1, process_id=0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"world of one on {dist.get_backend()}")
        mesh = par.make_mesh()

        # GRIDMF on gamma M - J of the npoint-513 Brusselator
        plan, vr, _, analyze_s = gridmf_setup(NPOINT_BSR)
        gp = plan.gridmf_plan
        b = torch.linspace(1.0, 2.0, plan.n, dtype=torch.float64,
                           device="cuda")

        def g_single():
            fac = gridmf.gridmf_factorize(gp, vr)
            return fac, gridmf.gridmf_solve(gp, fac, b)

        def g_dist():
            fac = par.dist_gridmf_factorize(mesh, gp, vr)
            return fac, par.dist_gridmf_solve(mesh, gp, fac, b)

        def g_cmp(s, d):
            bit_equal("gridmf x", s[1], d[1])
            gridmf_fac_equal("gridmf", gp, s[0], d[0])
            return {"n": plan.n, "depths": len(gp.levels),
                    "store_gb": gridmf.gridmf_store_gb(gp),
                    "analyze_s": analyze_s,
                    "residual": residual(plan, vr, d[1], b)}

        recs.append(par_world1_check(f"gridmf_{NPOINT_BSR}",
                                     g_single, g_dist, g_cmp, smi))
        del plan, vr, gp
        torch.cuda.empty_cache()

        # SPLU on the npoint-129 plan (the replay's gamma M - J)
        plan, vr, _ = replay_setup(NPOINT)
        sp = plan.splu_plan

        def s_cmp(s, d):
            bit_equal("splu", fac_stats(s) | {"blocks": s["blocks"]},
                      fac_stats(d) | {"blocks": d["blocks"]})
            return {"rows": len(sp.packed["t0"])}

        recs.append(par_world1_check(
            f"splu_{NPOINT}", lambda: splu.splu_factorize(sp, vr),
            lambda: par.dist_splu_factorize(mesh, sp, vr), s_cmp, smi))
        del plan, vr, sp

        # GENMF on geometric_264k
        coo = samples.irregular_geometric(GEOMETRIC_N, seed=0)
        ii, jj, vv = coo.triplets()
        splan = SHARED_PLANS.get("geometric_264k")
        t_a = time.perf_counter()
        if splan is None:
            splan = factor.analyze(coo.nrow, ii, jj, genie=Genie.GENMF)
        analyze_s = time.perf_counter() - t_a
        gmp = splan.genmf_plan
        vals = torch.as_tensor(vv, device="cuda")
        b = torch.as_tensor(np.random.default_rng(SEED).standard_normal(
            coo.nrow), device="cuda")

        def m_single():
            fac = genmf.genmf_factorize(gmp, vals)
            return fac, genmf.genmf_solve(gmp, fac, b)

        def m_dist():
            fac = par.dist_genmf_factorize(mesh, gmp, vals)
            return fac, par.dist_genmf_solve(mesh, gmp, fac, b)

        def m_cmp(s, d):
            bit_equal("genmf x", s[1], d[1])
            gridmf_fac_equal("genmf", gmp, s[0], d[0])
            return {"n": coo.nrow, "classes": len(gmp.classes),
                    "analyze_s": analyze_s}

        recs.append(par_world1_check("genmf_geometric_264k",
                                     m_single, m_dist, m_cmp, smi))
        del coo, splan, gmp, vals
        torch.cuda.empty_cache()

        # BANDED through cyclic reduction on laplacian_2d_317
        coo = samples.laplacian_2d(LAPLACIAN_2D_NPOINT)
        ii, jj, vv = coo.triplets()
        bplan = factor.analyze(coo.nrow, ii, jj)
        if not (bplan.genie == Genie.BANDED and bplan.use_bcr):
            raise AssertionError("laplacian_2d_317: AUTO did not take BCR")
        vals = torch.as_tensor(vv, device="cuda")
        b = torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
            coo.nrow), device="cuda")

        def c_single():
            fac = factor.numeric_factorize(bplan, vals)
            return fac, factor.factor_solve(bplan, fac, b)

        def c_dist():
            fac = par.shard_banded_factorize(mesh, bplan, vals)
            return fac, par.shard_banded_solve(mesh, bplan, fac, b)

        def c_cmp(s, d):
            bit_equal("bcr x", s[1], d[1])
            for i, (u, v) in enumerate(zip(s[0]["levels"], d[0]["levels"])):
                bit_equal(f"bcr level {i}", u, v)
            bit_equal("bcr root", s[0]["root"], d[0]["root"])
            bit_equal("bcr stats", fac_stats(s[0]), fac_stats(d[0]))
            return {"n": coo.nrow, "nb": bplan.nb, "k": bplan.block_k,
                    "levels": len(d[0]["levels"])}

        recs.append(par_world1_check("bcr_laplacian_2d_317",
                                     c_single, c_dist, c_cmp, smi))
        del coo, bplan, vals

        # SpMV on the npoint-513 Jacobian
        coo = brusselator_jacobian(NPOINT_BSR)
        csr = CsrMatrix.from_coo(coo, "cuda")
        sh = par.shard_csr_rows(csr, 1)
        x = torch.as_tensor(np.random.default_rng(SEED + 2).standard_normal(
            coo.nrow), device="cuda")
        cols = torch.as_tensor(np.asarray(csr.indices, dtype=np.int64),
                               device="cuda")
        offsets = torch.as_tensor(np.asarray(csr.indptr, dtype=np.int64),
                                  device="cuda")
        want = scipy_csr(coo) @ x.cpu().numpy()

        def v_cmp(s, d):
            bit_equal("spmv y", s, d)
            err = float(np.abs(d.cpu().numpy() - want).max())
            if err > RTOL * float(np.abs(want).max()):
                raise AssertionError(f"spmv: {err} off scipy")
            return {"n": coo.nrow, "nnz": int(coo.nnz),
                    "max_abs_err_scipy": err}

        recs.append(par_world1_check(
            f"spmv_{NPOINT_BSR}",
            lambda: splu.segment_sum(csr.data * x[cols], None, offsets),
            lambda: par.dist_mat_vec_mul(mesh, sh, x), v_cmp, smi, REPS))
        del coo, csr, sh, x, cols, offsets

        # batch_factor_solve: PAR_BATCH shifts gamma_i M - J at npoint 129
        recs.append(par_world1_batch(mesh, smi))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return recs


def batch_inputs(npoint):
    """AUTO's GRIDMF SolvePlan at ``npoint`` and PAR_BATCH systems gamma_i M
    - J (gamma_i from 0.5 GAMMA to 1.5 GAMMA) with seeded right-hand sides,
    as host numpy (B, nnz) and (B, n)."""
    plan, vr, _, _ = gridmf_setup(npoint)
    n = plan.n
    jv = vr.cpu().numpy()[:-n]
    gammas = GAMMA * (0.5 + np.arange(PAR_BATCH) / PAR_BATCH)
    vals = np.concatenate([np.tile(jv, (PAR_BATCH, 1)),
                           gammas[:, None] * np.ones((1, n))], axis=1)
    rhs = np.random.default_rng(SEED + 3).standard_normal((PAR_BATCH, n))
    return plan, vals, rhs


def par_world1_batch(mesh, smi):
    from russell_tpu_torch import parallel as par
    from russell_tpu_torch.sparse import factor
    plan, vals, rhs = batch_inputs(NPOINT)
    vt = torch.as_tensor(vals, device="cuda")
    rt = torch.as_tensor(rhs, device="cuda")

    def single():
        # one device, one batched numeric phase, as each rank runs its rows
        return factor.factor_solve_batch(plan, vt, rt)

    def b_cmp(s, d):
        bit_equal("batch x", s, d)
        # and the batch against one numeric phase per system: the batched
        # GEMMs may take other cuBLAS kernels than a system's own
        loop = torch.stack([factor.factor_solve(
            plan, factor.numeric_factorize(plan, v), r)
            for v, r in zip(vt, rt)])
        err, scale = assert_close("batch x against one system a phase", s,
                                  loop)
        return {"n": plan.n, "batch": PAR_BATCH, "genie": plan.genie.value,
                "per_system_max_abs_err": err, "per_system_scale": scale,
                "per_system_bit_identical": bool(torch.equal(s, loop))}

    return par_world1_check(
        f"batch_factor_solve_{NPOINT}", single,
        lambda: par.batch_factor_solve(mesh, plan, vals, rhs), b_cmp, smi)


# part (b): each check's inputs (host, built by the parent), its call on
# one rank and its single-device call (both return dicts of tensors)

def par_inputs():
    from russell_tpu_torch import parallel as par
    from russell_tpu_torch.sparse import CsrMatrix, Genie, factor, samples
    inp = {}
    plan, vr, _, _ = gridmf_setup(129)
    inp["gridmf_129"] = {"plan": plan, "vals": vr.cpu().numpy(),
                         "rhs": np.linspace(1.0, 2.0, plan.n)}
    plan, vr, _ = replay_setup(65)
    inp["splu_65"] = {"plan": plan, "vals": vr.cpu().numpy(),
                      "rhs": np.linspace(1.0, 2.0, plan.n)}
    coo = samples.laplacian_3d(LAPLACIAN_3D_NPOINT)
    ii, jj, vv = coo.triplets()
    inp["genmf_laplacian_3d_50"] = {
        "plan": factor.analyze(coo.nrow, ii, jj, genie=Genie.GENMF),
        "vals": np.asarray(vv), "rhs": np.linspace(1.0, 2.0, coo.nrow)}
    coo = samples.laplacian_2d(LAPLACIAN_2D_NPOINT)
    ii, jj, vv = coo.triplets()
    inp["bcr_laplacian_2d_317"] = {
        "plan": factor.analyze(coo.nrow, ii, jj), "vals": np.asarray(vv),
        "rhs": np.linspace(1.0, 2.0, coo.nrow)}
    coo = brusselator_jacobian(NPOINT_BSR)
    sh = par.shard_csr_rows(CsrMatrix.from_coo(coo, "cpu"), PAR_RANKS)
    x = np.zeros(sh.n_pad)
    x[:coo.nrow] = np.random.default_rng(SEED + 2).standard_normal(coo.nrow)
    inp["spmv_513"] = {"sh": sh, "x": x, "coo": coo}
    plan, vals, rhs = batch_inputs(65)
    inp["batch_65"] = {"plan": plan, "vals": vals, "rhs": rhs}
    return inp


def par_dist(name, mesh, c, rank):
    """Check ``name`` on this rank of part (b): a dict of tensors."""
    from russell_tpu_torch import parallel as par
    from russell_tpu_torch.sparse import splu
    dev = torch.device("cuda")
    rhs = torch.as_tensor(c["rhs"], device=dev) if "rhs" in c else None
    if name == "gridmf_129":
        gp = c["plan"].gridmf_plan
        fac = par.dist_gridmf_factorize(mesh, gp, c["vals"])
        return {"sir": [lv["sir"] for lv in fac["levels"]],
                "ranges": fac["ranges"],
                "x": par.dist_gridmf_solve(mesh, gp, fac, rhs),
                **fac_stats(fac)}
    if name == "splu_65":
        sp = c["plan"].splu_plan
        fac = par.dist_splu_factorize(mesh, sp, c["vals"])
        return {"blocks": fac["blocks"], "x": splu.splu_solve(sp, fac, rhs),
                **fac_stats(fac)}
    if name == "genmf_laplacian_3d_50":
        gp = c["plan"].genmf_plan
        fac = par.dist_genmf_factorize(mesh, gp, c["vals"])
        return {"x": par.dist_genmf_solve(mesh, gp, fac, rhs),
                "ranges": fac["ranges"], **fac_stats(fac)}
    if name == "bcr_laplacian_2d_317":
        fac = par.shard_banded_factorize(mesh, c["plan"], c["vals"])
        return {"x": par.shard_banded_solve(mesh, c["plan"], fac, rhs),
                "ranges": [lv["range"] for lv in fac["levels"]],
                **fac_stats(fac)}
    if name == "spmv_513":
        rps = c["sh"].rows_per_shard
        return {"y": par.dist_mat_vec_mul(
            mesh, c["sh"], c["x"][rank * rps:(rank + 1) * rps])}
    if name == "batch_65":
        return {"x": par.batch_factor_solve(mesh, c["plan"], c["vals"],
                                            c["rhs"])}
    raise ValueError(name)


def par_single(name, c):
    """Check ``name`` on one device in the parent: a dict of tensors."""
    from russell_tpu_torch.sparse import CsrMatrix, factor, genmf, gridmf, splu
    dev = torch.device("cuda")
    rhs = torch.as_tensor(c["rhs"], device=dev) if "rhs" in c else None
    vals = torch.as_tensor(c["vals"], device=dev) if "vals" in c else None
    if name == "gridmf_129":
        gp = c["plan"].gridmf_plan
        fac = gridmf.gridmf_factorize(gp, vals)
        return {"sir": [lv["sir"] for lv in fac["levels"]],
                "x": gridmf.gridmf_solve(gp, fac, rhs), **fac_stats(fac)}
    if name == "splu_65":
        sp = c["plan"].splu_plan
        fac = splu.splu_factorize(sp, vals)
        return {"blocks": fac["blocks"], "x": splu.splu_solve(sp, fac, rhs),
                **fac_stats(fac)}
    if name == "genmf_laplacian_3d_50":
        gp = c["plan"].genmf_plan
        fac = genmf.genmf_factorize(gp, vals)
        return {"x": genmf.genmf_solve(gp, fac, rhs), **fac_stats(fac)}
    if name == "bcr_laplacian_2d_317":
        fac = factor.numeric_factorize(c["plan"], vals)
        return {"x": factor.factor_solve(c["plan"], fac, rhs),
                **fac_stats(fac)}
    if name == "spmv_513":
        # the rows' sums in CSR order over the whole matrix
        csr = CsrMatrix.from_coo(c["coo"], dev)
        x = torch.as_tensor(c["x"][:c["coo"].nrow], device=dev)
        cols = torch.as_tensor(np.asarray(csr.indices, dtype=np.int64),
                               device=dev)
        offsets = torch.as_tensor(np.asarray(csr.indptr, dtype=np.int64),
                                  device=dev)
        return {"y": splu.segment_sum(csr.data * x[cols], None, offsets)}
    if name == "batch_65":
        plan = c["plan"]
        return {"x": torch.stack([factor.factor_solve(
            plan, factor.numeric_factorize(plan, v), r) for v, r in zip(
                torch.as_tensor(c["vals"], device=dev),
                torch.as_tensor(c["rhs"], device=dev))])}
    raise ValueError(name)


def to_cpu(v):
    if torch.is_tensor(v):
        return v.cpu()
    if isinstance(v, dict):
        return {k: to_cpu(u) for k, u in v.items()}
    if isinstance(v, (list, tuple)):
        return [to_cpu(u) for u in v]
    return v


def par_rank(rank, world, tmp):
    """One rank of part (b): join the gloo world (a file store in ``tmp``)
    on cuda:0, run every check twice (cold, then warm: its result, wall,
    CUDA-event span and launches) and write them to ``tmp``/rank<r>.pt."""
    import pickle
    import torch.distributed as dist
    from russell_tpu_torch import parallel as par
    par.initialize_multihost(init_method=f"file://{tmp}/store",
                             num_processes=world, process_id=rank,
                             backend="gloo")
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        mesh = par.make_mesh()
        out = {"device": str(torch.cuda.current_device())}
        for name, c in inputs.items():
            rec = {}
            for run in ("cold", "warm"):
                dist.barrier()
                reset_launch_counts()
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                res = par_dist(name, mesh, c, rank)
                e1.record()
                torch.cuda.synchronize()
                rec[run] = {"wall_s": time.perf_counter() - t0,
                            "event_ms": e0.elapsed_time(e1),
                            "launches": kernel_counts()}
            rec["result"] = to_cpu(res)
            out[name] = rec
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def rel_close(name, got, want, tol):
    got = torch.as_tensor(got, dtype=torch.float64).cpu()
    want = torch.as_tensor(want, dtype=torch.float64).cpu()
    err = float((got - want).abs().max())
    if not err <= tol * (1 + float(want.abs().max())):
        raise AssertionError(f"{name}: {err} off the single-device result")
    return err


def whole(name, ranks_res, key):
    """A split factorization's per-depth (or per-class) blocks put
    together in rank order, checked against each rank's range."""
    items = []
    for i, rng in enumerate(ranks_res[0]["ranges"]):
        if rng is None:
            items.append(ranks_res[0][key][i])
            continue
        n = rng[1] - rng[0]
        for r, rr in enumerate(ranks_res):
            if tuple(rr["ranges"][i]) != (r * n, (r + 1) * n):
                raise AssertionError(f"{name}: rank {r} holds "
                                     f"{rr['ranges'][i]} of item {i}")
        items.append(torch.cat([rr[key][i] for rr in ranks_res]))
    return items


def par_compare(name, c, want, ranks_res):
    """Hold the ranks' results of check ``name`` to the single-device
    ``want`` at the reference tests' f64 bounds; returns the errors."""
    err = {}
    if name == "spmv_513":
        y = torch.cat([r["y"] for r in ranks_res])[:c["coo"].nrow]
        err["y"] = rel_close(name, y, want["y"], PAR_FAC_TOL)
        return err
    x = ranks_res[0]["x"]
    for r, rr in enumerate(ranks_res[1:], 1):
        err[f"x_rank_{r}_vs_0"] = float((rr["x"] - x).abs().max())
    err["x"] = rel_close(f"{name} x", x, want["x"], PAR_FAC_TOL)
    if name == "batch_65":
        return err
    for k in ("sir", "blocks"):
        if k in want:
            got = (whole(name, ranks_res, k) if k == "sir"
                   else [ranks_res[0][k]])
            ref = want[k] if k == "sir" else [want[k]]
            err[k] = max(rel_close(f"{name} {k}[{i}]", g, w, PAR_FAC_TOL)
                         for i, (g, w) in enumerate(zip(got, ref)))
    plan = c["plan"]
    rows = torch.as_tensor(np.asarray(plan.rows, dtype=np.int64))
    cols = torch.as_tensor(np.asarray(plan.cols, dtype=np.int64))
    ax = torch.zeros(plan.n, dtype=torch.float64).index_add_(
        0, rows, torch.as_tensor(c["vals"]) * x[cols])
    res = float((ax - torch.as_tensor(c["rhs"])).abs().max())
    if not res < PAR_RES_TOL:
        raise AssertionError(f"{name}: residual {res}")
    err["residual"] = res
    ld = abs(float(ranks_res[0]["logdet"]) - float(want["logdet"]))
    if not ld < PAR_LOGDET_TOL:
        raise AssertionError(f"{name}: log|det| {ld} off")
    err["logdet"] = ld
    return err


def par_ranks(smi):
    """Part (b): PAR_RANKS ranks spawned on the one card under gloo, each
    check held to the parent's single-device run of it; each rank must
    launch splu_pairs and gather_rows (SPLU) and gj_inv (SPLU, GRIDMF,
    GENMF, the batch)."""
    import multiprocessing
    import pickle
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="parallel_ranks_")
    try:
        inputs = par_inputs()
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        inputs_s = time.perf_counter() - t0
        single = {}
        for name, c in inputs.items():
            par_single(name, c)                 # cold: uploads, caches
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            e0.record()
            out = par_single(name, c)
            e1.record()
            torch.cuda.synchronize()
            single[name] = {"wall_s": time.perf_counter() - t1,
                            "event_ms": e0.elapsed_time(e1),
                            "result": to_cpu(out)}
        torch.cuda.empty_cache()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=par_rank, args=(r, PAR_RANKS, tmp))
                 for r in range(PAR_RANKS)]
        t1 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = t1 + PAR_RANK_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if hung:
            raise AssertionError(f"parallel ranks {hung} did not finish in "
                                 f"{PAR_RANK_TIMEOUT_S} s")
        codes = [p.exitcode for p in procs]
        if codes != [0] * PAR_RANKS:
            raise AssertionError(f"parallel rank exit codes {codes}")
        ranks_s = time.perf_counter() - t1
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False) for r in range(PAR_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    recs = []
    for name, c in inputs.items():
        per_rank = [r[name] for r in res]
        err = par_compare(name, c, single[name]["result"],
                          [r["result"] for r in per_rank])
        launches = [r["warm"]["launches"] for r in per_rank]
        need = (("splu_pairs", "gather_rows", "gj_inv") if name == "splu_65"
                else ("gj_inv",) if name in ("gridmf_129",
                                             "genmf_laplacian_3d_50",
                                             "batch_65") else ())
        for k in need:
            idle = [r for r, lr in enumerate(launches) if lr[k] <= 0]
            if idle:
                raise AssertionError(f"{name}: {k} not launched on ranks "
                                     f"{idle}")
        rec = {"check": name, "world": PAR_RANKS, "backend": "gloo",
               "single_wall_s": single[name]["wall_s"],
               "single_event_ms": single[name]["event_ms"],
               "rank_cold_wall_s": [r["cold"]["wall_s"] for r in per_rank],
               "rank_warm_wall_s": [r["warm"]["wall_s"] for r in per_rank],
               "rank_warm_event_ms": [r["warm"]["event_ms"]
                                      for r in per_rank],
               "rank_launches": launches, "errors": err, "card": smi}
        say("parallel_path", part="ranks", **rec)
        recs.append(rec)
    say("parallel_path", part="ranks_done", inputs_s=inputs_s,
        ranks_s=ranks_s, devices=[r["device"] for r in res])
    return recs


def phase_parallel_path():
    """Phase 26: ``russell_tpu_torch.parallel`` on the card (the module
    docstring's item 26). Returns the records of both parts; the kernels
    line takes their launches."""
    t0 = time.perf_counter()
    smi = nvidia_smi()
    world1 = par_world1(smi)
    ranks = par_ranks(smi)
    say("parallel_path", part="done", wall_s=time.perf_counter() - t0,
        card=smi)
    return {"world_1": world1, "ranks": ranks}


def parallel_entry(pres, name):
    """A kernel's launches in phase 26: per world-of-one call, and per rank
    in the 4-rank world (warm runs)."""
    return {"world_1_launches": {r["check"]: r["dist"]["launches"][name]
                                 for r in pres["world_1"]},
            f"ranks_{PAR_RANKS}_launches": {
                r["check"]: [lr[name] for lr in r["rank_launches"]]
                for r in pres["ranks"]}}


# -- ooc_path ------------------------------------------------------------------

OOC_NPOINT_IN_CORE = 60   # laplacian_3d, hint (N, N, N): 13.2 GiB of factors
OOC_NPOINT = 79           # 49.1 GiB: out of core by the default budget;
                          # the host pins 60 GiB (factors, Schur buffers)
OOC_RES_TOL = 1e-10       # VerifyLinSys relative error
OOC_X_TOL = 1e-12         # out-of-core x against in-core x, of max|x|
OOC_LOGDET_RTOL = 1e-10   # log|det| against the analytic sum
OOC_COPY_BYTES = 1 << 30  # the pinned copy_ that is the transfers' yardstick


def lap3d_logdet(npoint):
    """log|det| of ``samples.laplacian_3d(npoint)``: c (T x I x I + I x T x I
    + I x I x T) with T = tridiag(-1, 2, -1) of size N and c = (N - 1)^2,
    so its eigenvalues are c (mu_i + mu_j + mu_k), mu_m = 2 - 2 cos(m pi /
    (N + 1))."""
    mu = 2.0 - 2.0 * np.cos(np.arange(1, npoint + 1) * np.pi / (npoint + 1))
    c = float(npoint - 1) ** 2
    s = mu[:, None, None] + mu[None, :, None] + mu[None, None, :]
    return math.fsum(np.log(c * s).ravel())


def det_logabs(sol):
    """log|det| from LinSolver.determinant's (mantissa, 10, exponent)."""
    m, base, e = sol.determinant()
    return (e + math.log10(abs(m))) * math.log(base)


def copy_gbps(host, dev):
    """(H2D, D2H) GB/s of one ``copy_`` between ``host`` and ``dev`` (the same
    bytes), each the median of three timed by CUDA events."""
    out = []
    for dst, src in ((dev, host), (host, dev)):
        times = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        out.append(host.numel() * host.element_size() / statistics.median(
            times) / 1e9)
    return out


def copy_yardstick():
    """The transfers' yardstick: a plain 1 GiB ``copy_`` from and to torch's
    pinned memory, and the same from and to a store of the out-of-core path
    (an anonymous mapping registered with CUDA), in GB/s; and the GB/s of
    making each (torch's pinned allocation, and ``gridmf._host_empty``'s
    mapping and registration) on the idle card."""
    from russell_tpu_torch.sparse import gridmf
    dev = torch.empty(OOC_COPY_BYTES, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pinned = torch.empty(OOC_COPY_BYTES, dtype=torch.uint8, pin_memory=True)
    alloc_s = time.perf_counter() - t0
    h2d, d2h = copy_gbps(pinned, dev)
    t0 = time.perf_counter()
    store = gridmf._host_empty((OOC_COPY_BYTES,), torch.uint8, dev.device)
    register_s = time.perf_counter() - t0
    s_h2d, s_d2h = copy_gbps(store, dev)
    del dev, pinned, store
    return {"pinned_h2d_gbps": h2d, "pinned_d2h_gbps": d2h,
            "registered_h2d_gbps": s_h2d, "registered_d2h_gbps": s_d2h,
            "pinned_alloc_gbps": OOC_COPY_BYTES / alloc_s / 1e9,
            "map_and_register_gbps": OOC_COPY_BYTES / register_s / 1e9}


def store_bytes(fac):
    return sum(t.numel() * t.element_size() for st in fac["levels"]
               for t in st.values() if t is not None)


def copy_device_ms(ms_by_name, way):
    """Summed device ms of the profiled copies one way ("HtoD", "DtoH")."""
    return sum(v for k, v in ms_by_name.items() if way in k)


def compute_busy(ms_by_name, wall_s):
    """Kernel device time (copies excluded) over the wall."""
    return sum(v for k, v in ms_by_name.items()
               if "Memcpy" not in k and "Memset" not in k) / (1e3 * wall_s)


def ooc_in_core_limit(res):
    """(a) laplacian_3d(OOC_NPOINT_IN_CORE) with the hint (N, N, N) through
    LinSolver(AUTO): in core by the default budget, then out of core with
    the budget under its store; x, log|det|, min|pivot| and n_perturbed
    held between the two."""
    from russell_tpu_torch.sparse import (Genie, LinSolParams, LinSolver,
                                          VerifyLinSys, factor, gridmf,
                                          samples)
    N = OOC_NPOINT_IN_CORE
    coo = samples.laplacian_3d(N)
    n = coo.nrow
    b = np.random.default_rng(SEED + 17).standard_normal(n)
    params = LinSolParams(grid=(N, N, N))
    runs = {}
    budget = factor.GRIDMF_BUDGET_GB
    for ooc in (False, True):
        rec = {}
        s = LinSolver(Genie.AUTO, device="cuda")
        if ooc:
            # under the store: out of core
            factor.GRIDMF_BUDGET_GB = 0.5 * res["store_gib_60"]
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            s.factorize(coo, params)
            rec["cold_factorize_s"] = time.perf_counter() - t0
            rec["analyze_s"] = s.stats.time_nanoseconds["initialize"] / 1e9
            rec["gj_inv_launches"] = gj_inv_launches()
            if not ooc:
                # out of core, each factorization maps and pins its stores
                # anew: one is timed
                t0 = time.perf_counter()
                s.factorize(coo, params)
                torch.cuda.synchronize()
                rec["warm_factorize_s"] = time.perf_counter() - t0
            rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
            t0 = time.perf_counter()
            x = s.solve(b)
            rec["solve_s"] = time.perf_counter() - t0
        finally:
            factor.GRIDMF_BUDGET_GB = budget
        rec["out_of_core"] = bool(s.stats.output.get("out_of_core"))
        if rec["out_of_core"] is not ooc or s.plan.genie != Genie.GRIDMF:
            raise AssertionError(f"laplacian_3d_{N}: genie {s.plan.genie}, "
                                 f"out of core {rec['out_of_core']}")
        if ooc:
            rec["pinned_bytes"] = s.fac["levels"].pinned_bytes
            rec["store_bytes"] = store_bytes(s.fac)
        rec["relative_error"] = VerifyLinSys.from_system(
            coo, x.cpu().numpy(), b).relative_error
        rec["stats"] = {k: s.fac[k].item() for k in (
            "logdet", "min_pivot", "n_perturbed")}
        say("ooc_path", part=f"3d_{N}_" + ("out_of_core" if ooc else
                                           "in_core"), **rec)
        runs[ooc] = (rec, x)
        del s
        gc.collect()
        torch.cuda.empty_cache()
    (ri, xi), (ro, xo) = runs[False], runs[True]
    scale = float(xi.abs().max())
    err = float((xo - xi).abs().max())
    if not err <= OOC_X_TOL * scale:
        raise AssertionError(f"laplacian_3d_{N}: out-of-core x off the "
                             f"in-core x by {err} (max|x| {scale})")
    if ri["stats"] != ro["stats"]:
        raise AssertionError(f"laplacian_3d_{N}: statistics differ in and "
                             f"out of core: {ri['stats']} {ro['stats']}")
    if not ro["peak_mem_bytes"] < ri["peak_mem_bytes"]:
        raise AssertionError(f"laplacian_3d_{N}: out-of-core peak "
                             f"{ro['peak_mem_bytes']} not under the in-core "
                             f"{ri['peak_mem_bytes']}")
    for r in (ri, ro):
        if not r["relative_error"] <= OOC_RES_TOL:
            raise AssertionError(f"laplacian_3d_{N}: relative error "
                                 f"{r['relative_error']}")
    res["3d_60"] = {"in_core": ri, "out_of_core": ro,
                    "x_max_abs_diff": err, "x_max_abs": scale}
    say("ooc_path", part=f"3d_{N}_held", x_max_abs_diff=err, x_max_abs=scale,
        stats_equal=True, peak_ratio=ro["peak_mem_bytes"]
        / ri["peak_mem_bytes"])


def ooc_full(res):
    """(b) laplacian_3d(OOC_NPOINT) with the hint (N, N, N) through
    LinSolver(AUTO): out of core by the default budget. One factorization
    under the profiler (wall, launches, the copies' device time, the busy
    share) with the first gj_inv launch at each shape held to its plain
    version; a solve, VerifyLinSys and the determinant against the
    analytic log|det|; one sweep pair under the profiler."""
    from russell_tpu_torch.sparse import (Genie, LinSolParams, LinSolver,
                                          VerifyLinSys, factor, gridmf,
                                          samples)
    N = OOC_NPOINT
    t0 = time.perf_counter()
    coo = samples.laplacian_3d(N)
    n = coo.nrow
    b = np.random.default_rng(SEED + 79).standard_normal(n)
    rec = {"n": n, "nnz": int(coo.nnz), "build_s": time.perf_counter() - t0}
    s = LinSolver(Genie.AUTO, device="cuda")
    params = LinSolParams(grid=(N, N, N))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with held_once_a_shape() as held:
        ms, wall, launches = kernel_device_ms(
            lambda: s.factorize(coo, params))
    rec["analyze_s"] = s.stats.time_nanoseconds["initialize"] / 1e9
    rec["factorize_s"] = s.stats.time_nanoseconds["factorize"] / 1e9
    rec["gj_inv_launches"] = gj_inv_launches()
    rec["peak_mem_factorize_bytes"] = torch.cuda.max_memory_allocated()
    n_shapes = len(held["gj_inv"]["shapes"])
    rec["held_to_plain"] = held_record(held, {"gj_inv": n_shapes})["gj_inv"]
    rec["held_to_plain"]["shapes_list"] = sorted(held["gj_inv"]["shapes"])
    del held
    if not s.stats.output.get("out_of_core"):
        raise AssertionError(f"laplacian_3d_{N}: not out of core")
    # the busy share over the numeric factorization (the profiled wall
    # holds the host analysis too)
    p = {"analyze_and_factorize_wall_s": wall,
         "factorize_device_launches": launches,
         "factorize_busy": compute_busy(ms, rec["factorize_s"]),
         "d2h_device_s": copy_device_ms(ms, "DtoH") / 1e3}
    plan = s.plan.gridmf_plan
    rec["levels"] = [(lv.n_nodes, lv.F, lv.e) for lv in plan.levels]
    rec["store_bytes"] = store_bytes(s.fac)
    rec["pinned_bytes"] = s.fac["levels"].pinned_bytes
    rec["flops"] = gridmf.gridmf_flops(plan)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x = s.solve(b)
    rec["solve_s"] = time.perf_counter() - t0
    rec["peak_mem_solve_bytes"] = torch.cuda.max_memory_allocated()
    rec["relative_error"] = VerifyLinSys.from_system(
        coo, x.cpu().numpy(), b).relative_error
    got = det_logabs(s)
    want = lap3d_logdet(N)
    rec["logdet"], rec["logdet_analytic"] = got, want
    rec["logdet_rel_err"] = abs(got - want) / abs(want)
    if not rec["relative_error"] <= OOC_RES_TOL:
        raise AssertionError(f"laplacian_3d_{N}: relative error "
                             f"{rec['relative_error']}")
    if not rec["logdet_rel_err"] <= OOC_LOGDET_RTOL:
        raise AssertionError(f"laplacian_3d_{N}: log|det| {got} against "
                             f"{want}")
    if not rec["peak_mem_factorize_bytes"] < rec["store_bytes"]:
        raise AssertionError(f"laplacian_3d_{N}: peak device memory over "
                             "the store's bytes")
    del x
    bt = torch.as_tensor(b, device="cuda")
    ms, wall, _ = kernel_device_ms(
        lambda: factor.factor_solve(s.plan, s.fac, bt, refine_steps=0))
    p.update(sweeps_wall_s=wall, sweeps_busy=compute_busy(ms, wall),
             h2d_device_s=copy_device_ms(ms, "HtoD") / 1e3)
    rec["profiled"] = p
    # every byte of the store crosses once a factorization and a sweep pair
    sb = rec["store_bytes"]
    rec["d2h_gbps_wall"] = sb / rec["factorize_s"] / 1e9
    rec["d2h_gbps_device"] = sb / max(p["d2h_device_s"], 1e-9) / 1e9
    rec["h2d_gbps_wall"] = sb / p["sweeps_wall_s"] / 1e9
    rec["h2d_gbps_device"] = sb / max(p["h2d_device_s"], 1e-9) / 1e9
    rec["gflops_factorize"] = rec["flops"] / rec["factorize_s"] / 1e9
    t0 = time.perf_counter()
    del s, bt
    gc.collect()
    rec["free_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    say("ooc_path", part=f"3d_{N}", **rec)
    res[f"3d_{N}"] = rec


def phase_ooc_path():
    """GRIDMF out of core through LinSolver on the card: the in-core limit
    at laplacian_3d_60 and its out-of-core run, then laplacian_3d_79, with
    the transfers' yardstick and the host's memory."""
    from russell_tpu_torch.sparse import gridmf, samples
    t_start = time.perf_counter()
    with open("/proc/meminfo") as f:
        mem = {ln.split(":")[0]: int(ln.split()[1]) for ln in f}
    res = {"mem_available_gib": mem["MemAvailable"] / 2 ** 20,
           "mem_total_gib": mem["MemTotal"] / 2 ** 20}
    N = OOC_NPOINT_IN_CORE
    coo = samples.laplacian_3d(N)
    ii, jj, _ = coo.triplets()
    res["store_gib_60"] = gridmf.gridmf_store_gb(gridmf.gridmf_analyze(
        coo.nrow, np.asarray(ii), np.asarray(jj), (N, N, N),
        leaf_cells=16))
    del coo, ii, jj
    res["yardstick"] = copy_yardstick()
    say("ooc_path", part="setup", **res)
    ooc_in_core_limit(res)
    ooc_full(res)
    res["wall_s"] = time.perf_counter() - t_start
    say("ooc_path", part="done", wall_s=res["wall_s"])
    return res


def ooc_entry(ores):
    """The ooc_path numbers of gj_inv's entry on the kernels line."""
    full = ores[f"3d_{OOC_NPOINT}"]
    return {"launches_3d_79_factorization": full["gj_inv_launches"],
            "launches_3d_60_out_of_core": ores["3d_60"]["out_of_core"][
                "gj_inv_launches"],
            "launches_3d_60_in_core": ores["3d_60"]["in_core"][
                "gj_inv_launches"],
            "held_to_plain_3d_79": full["held_to_plain"]}


# -- examples_path -----------------------------------------------------------

# the examples whose first kernel launch at each shape is held to the
# plain version: the main path's (AUTO -> GRIDMF -> gj_inv, fused), SPLU's
# (splu_pairs, gather_rows, gj_inv) and the Jacobi rotations' (jacobi_eig)
EXAMPLES_HELD = ("ex_ode_brusselator_pde_radau5.py", "ex_sparse_nd_splu.py",
                 "ex_lab_eigen_symmetric.py")
EXAMPLES_KERNELS = ("gj_inv", "splu_pairs", "gather_rows", "jacobi_eig")
EXAMPLES_CPU_TIMEOUT_S = 600


def start_examples_cpu():
    """Start every example on the CPU in a subprocess (niced, one intra-op
    thread, jax refused: ``examples_torch/_run.py``): {"proc", "out",
    "tmp", "t0"}, for ``examples_cpu`` to collect."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="examples_cpu_")
    out = os.path.join(tmp, "records.json")
    env = dict(os.environ, PYTHONPATH=root, **ONE_THREAD_ENV)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(root, "examples_torch", "_run.py"),
         "--device", "cpu", "--out", out], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        preexec_fn=lambda: os.nice(10))
    return {"proc": proc, "out": out, "tmp": tmp, "t0": time.perf_counter()}


def examples_cpu(cpu):
    """The CPU run's records by name and its wall; it fails if the run
    failed, loaded jax or an example raised."""
    import shutil
    try:
        _, err = cpu["proc"].communicate(timeout=EXAMPLES_CPU_TIMEOUT_S)
        if cpu["proc"].returncode != 0:
            raise AssertionError(f"examples on the CPU exited "
                                 f"{cpu['proc'].returncode}: {err[-2000:]}")
        with open(cpu["out"]) as f:
            run = json.load(f)
    finally:
        stop_examples_cpu(cpu)
        shutil.rmtree(cpu["tmp"], ignore_errors=True)
    if run["refused_modules_loaded"]:
        raise AssertionError(f"examples on the CPU loaded "
                             f"{run['refused_modules_loaded']}")
    recs = {r["name"]: r for r in run["records"]}
    for name, r in recs.items():
        if r["error"] is not None:
            raise AssertionError(f"{name} on the CPU: {r['error']}")
    return recs


def stop_examples_cpu(cpu):
    if cpu["proc"].poll() is None:
        cpu["proc"].kill()
        cpu["proc"].wait()


@contextlib.contextmanager
def held_once_a_shape():
    """Within the block, the first launch of gj_inv at each (w, m), of
    splu_pairs at each (n_live, be) and of gather_rows at each (rows,
    width) is held against its plain version (``held_to_plain``'s checks,
    on the path's own inputs and strides), and of jacobi_eig at each
    (n, sweeps) bit for bit against ``_jacobi_eig_plain``; the others run
    unchecked, as do launches made while a CUDA graph is captured (a fused
    loop's warm-up has launched each shape before its capture). Yields
    held_to_plain's record with jacobi_eig's beside it; the wrappers keep
    counting their launches."""
    from russell_tpu_torch.dense import matrix_ops
    from russell_tpu_torch.sparse import splu
    keys = {"gj_inv": lambda D, delta: (D.shape[0], D.shape[-1]),
            "splu_pairs": lambda *a: (a[5], a[6]),
            "gather_rows": lambda blocks, idx: (idx.numel(),
                                                blocks.shape[1])}
    attrs = {"gj_inv": "_gj_inv", "splu_pairs": "splu_pairs",
             "gather_rows": "gather_rows"}
    real = {k: getattr(splu, a) for k, a in attrs.items()}
    orig_jacobi = matrix_ops.jacobi_eig
    with held_to_plain() as held:
        checks = {k: getattr(splu, a) for k, a in attrs.items()}
        held["jacobi_eig"] = {"calls": 0, "shapes": collections.Counter(),
                              "max_abs_err": 0.0}

        def once(k):
            def call(*args):
                if (keys[k](*args) in held[k]["shapes"]
                        or torch.cuda.is_current_stream_capturing()):
                    return real[k](*args)
                return checks[k](*args)
            call.launches = checks[k].launches
            call.launches_f32 = checks[k].launches_f32
            return call

        def jacobi(a, max_sweeps=matrix_ops.JACOBI_SWEEPS):
            out = orig_jacobi(a, max_sweeps)
            h = held["jacobi_eig"]
            key = (a.shape[-1], int(max_sweeps))
            if key not in h["shapes"]:
                want = matrix_ops._jacobi_eig_plain(a, max_sweeps)
                if not all(torch.equal(g, w) for g, w in zip(out, want)):
                    raise AssertionError(f"jacobi_eig n {key[0]} on the "
                                         "path: not the plain version's bits")
                h["calls"] += 1
                h["shapes"][key] += 1
            return out

        jacobi.launches = orig_jacobi.launches
        wrapped = {k: once(k) for k in attrs}
        for k, a in attrs.items():
            setattr(splu, a, wrapped[k])
        matrix_ops.jacobi_eig = jacobi
        try:
            yield held
        finally:
            for k, a in attrs.items():
                checks[k].launches = wrapped[k].launches
                checks[k].launches_f32 = wrapped[k].launches_f32
                setattr(splu, a, checks[k])
            orig_jacobi.launches = jacobi.launches
            matrix_ops.jacobi_eig = orig_jacobi


def examples_counts():
    from russell_tpu_torch.dense import matrix_ops
    return {**kernel_counts(), "jacobi_eig": matrix_ops.jacobi_eig.launches}


def phase_examples_path(cpu=None):
    """Phase 28: every port example on the card, each held to its CPU run
    (``cpu``: ``start_examples_cpu``'s, else one started here); the four
    kernels counted over the phase. Returns the record."""
    from examples_torch import _run, _stdout
    t0 = time.perf_counter()
    if cpu is None:
        cpu = start_examples_cpu()
    try:
        _run.import_package()
        reset_launch_counts()
        recs, held, per_example = {}, {}, {}
        for path in _run.example_paths():
            name = os.path.basename(path)
            before = examples_counts()
            if name in EXAMPLES_HELD:
                with held_once_a_shape() as h:
                    rec = _run.run_one(path, "cuda", catch=False)
                held[name] = {k: {"held": h[k]["calls"],
                                  "shapes": len(h[k]["shapes"]),
                                  "max_abs_err": h[k]["max_abs_err"]}
                              for k in EXAMPLES_KERNELS}
            else:
                rec = _run.run_one(path, "cuda", catch=False)
            torch.cuda.synchronize()
            if rec["changed_settings"]:
                raise AssertionError(f"{name} left changed: "
                                     f"{rec['changed_settings']}")
            recs[name] = rec
            launched = {k: v - before[k] for k, v in examples_counts().items()
                        if v > before[k]}
            if launched:
                per_example[name] = launched
            say("examples_path", example=name, wall_s=rec["wall_s"],
                lines=len(rec["stdout"].splitlines()), launches=launched)
        counts = examples_counts()
        t_cpu = time.perf_counter()
        cpu_recs = examples_cpu(cpu)
        cpu_wait = time.perf_counter() - t_cpu
    finally:
        stop_examples_cpu(cpu)
    if set(cpu_recs) != set(recs):
        raise AssertionError("the CPU run and the card's ran other examples")
    diffs = {name: _stdout.compare(cpu_recs[name]["stdout"], r["stdout"],
                                   name) for name, r in recs.items()}
    diffs = {k: v for k, v in diffs.items() if v}
    walls = {name: r["wall_s"] for name, r in recs.items()}
    res = {"examples": len(recs), "launches": counts, "held": held,
           "launches_by_example": per_example,
           "card_walls_s": walls, "card_wall_s": sum(walls.values()),
           "cpu_walls_s": {n: r["wall_s"] for n, r in cpu_recs.items()},
           "cpu_wall_s": sum(r["wall_s"] for r in cpu_recs.values()),
           "cpu_wait_s": cpu_wait,
           "slowest_on_card": sorted(walls, key=walls.get)[-5:],
           "differ_from_cpu": diffs}
    say("examples_path", part="done", wall_s=time.perf_counter() - t0,
        **{k: v for k, v in res.items()
           if k not in ("card_walls_s", "cpu_walls_s")})
    if diffs:
        raise AssertionError(f"examples whose card output is not their CPU "
                             f"output: {diffs}")
    for k in EXAMPLES_KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"examples_path: {k} was not launched")
        if not any(h[k]["held"] for h in held.values()):
            raise AssertionError(f"examples_path: no {k} launch was held "
                                 "to its plain version")
    return res


def examples_entry(eres, name):
    """A kernel's examples_path numbers on the kernels line."""
    return {"launches": eres["launches"][name],
            "held_to_plain": {ex: h[name] for ex, h in eres["held"].items()
                              if h[name]["held"]},
            "examples_launching": sorted(
                ex for ex, c in eres["launches_by_example"].items()
                if name in c)}


# -- mixed_path ----------------------------------------------------------------

MIXED_NPOINT = 1000        # laplacian_2d, 10^6 unknowns, through GRIDMF
MIXED_SPLU_NPOINT = 50     # laplacian_3d_50 through SPLU
MIXED_GENMF_N = 20_000     # irregular_geometric, complex values, GENMF
MIXED_OOC_NPOINT = 40      # laplacian_3d, hint (N, N, N), out of core
MIXED_X_RTOL = 1e-10       # x against the f64 route's, of max|x|
MIXED_BYTES_RATIO = 0.55   # f32 factor bytes over the f64 route's, at most
F32_KERNELS = ("splu_pairs", "gather_rows", "gj_inv")
HELD_F32 = [{}]            # the f32 launches of the held factorizations


def f32_counts():
    """The f32 builds' launch counts."""
    from russell_tpu_torch.sparse import splu
    return {k: getattr(splu, a).launches_f32 for k, a in (
        ("splu_pairs", "splu_pairs"), ("gather_rows", "gather_rows"),
        ("gj_inv", "_gj_inv"))}


def factor_bytes(fac):
    """Bytes of a factorization's stored factors (device or host)."""
    for key in ("levels", "classes"):
        if key in fac:
            return sum(t.numel() * t.element_size() for st in fac[key]
                       for t in st.values() if isinstance(t, torch.Tensor))
    t = fac["blocks"] if "blocks" in fac else fac["lu"]
    return t.numel() * t.element_size()


def factor_dtype(fac):
    """The dtype of a factorization's stored factors."""
    for key in ("levels", "classes"):
        if key in fac:
            return fac[key][0]["sir"].dtype
    return (fac["blocks"] if "blocks" in fac else fac["lu"]).dtype


def rel_x_err(x, want):
    """max |x - want| / max |want| (on the card)."""
    return float((x - want).abs().max() / want.abs().max())


def mixed_runs(name, plan, vals, b, held="all", warm=2, cold=False):
    """``plan``'s factorization of ``vals`` and its solve of ``b`` through
    ``factor`` (the numeric phase LinSolver runs, without its host
    bookkeeping), ``warm`` times after a cold one when ``cold``: walls,
    peak memory, factor bytes, the f32 launches of a factorization, the
    refinement's rounds of the first solve; then one more factorization
    whose every launch (``held`` "all"), or first launch at each shape
    ("once"), is held to the plain version. Returns (record, factors,
    x)."""
    from russell_tpu_torch.sparse import factor

    def fact():
        fac = factor.numeric_factorize(plan, vals)
        float(fac["min_pivot"])
        return fac

    t_part = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = {}
    if cold:
        t0 = time.perf_counter()
        fac = fact()
        rec["cold_factorize_s"] = time.perf_counter() - t0
    walls = []
    for _ in range(warm):
        fac = None
        c0 = f32_counts()
        t0 = time.perf_counter()
        fac = fact()
        walls.append(time.perf_counter() - t0)
        c1 = f32_counts()
    launches = {k: c1[k] - c0[k] for k in c1}
    rec.update(warm_factorize_s=walls, factor_bytes=factor_bytes(fac),
               launches_f32_per_factorization=launches)
    factor.factor_solve.refinement = {}
    walls = []
    for _ in range(warm):
        t0 = time.perf_counter()
        x = factor.factor_solve(plan, fac, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not rec.get("refinement"):
            rec["refinement"] = dict(factor.factor_solve.refinement)
    rec["warm_solve_s"] = walls
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    if held and any(launches.values()):
        fac = None
        with (held_to_plain() if held == "all"
              else held_once_a_shape()) as h:
            fac = fact()
        # the held run's launches, left out of the path's counts
        HELD_F32[0] = {k: HELD_F32[0].get(k, 0) + v
                       for k, v in launches.items()}
        if held == "all":
            rec["held_to_plain"] = held_record(
                h, {k: v for k, v in launches.items() if v})
        else:
            rec["held_once_a_shape"] = {
                k: {"shapes": len(h[k]["shapes"]),
                    "max_abs_err": h[k]["max_abs_err"]}
                for k in launches if launches[k]}
        rec["held_shapes"] = {k: sorted(h[k]["shapes"].items()) for k in h
                              if h[k]["calls"]}
    rec["wall_s"] = time.perf_counter() - t_part
    say("mixed_path", part=name, **{k: v for k, v in rec.items()
                                    if k != "held_shapes"})
    return rec, fac, x


def user_run(name, s, mat, params, b):
    """The user's path: ``LinSolver.factorize`` (the host analysis, the
    symmetry check, a cold factorization) and one ``solve`` (with its
    escalation probe), timed. Returns (record, x)."""
    from russell_tpu_torch.sparse import factor
    t0 = time.perf_counter()
    s.factorize(mat, params)
    rec = {"analyze_s": s.stats.time_nanoseconds["initialize"] / 1e9,
           "cold_factorize_s": s.stats.time_nanoseconds["factorize"] / 1e9,
           "genie": s.plan.genie.value, "mixed32": s.plan.mixed32,
           "symmetric_values": s.plan.symmetric_values}
    factor.factor_solve.refinement = {}
    t1 = time.perf_counter()
    x = s.solve(b)
    rec.update(first_solve_s=time.perf_counter() - t1,
               refinement=dict(factor.factor_solve.refinement),
               precision_escalated=bool(
                   s.stats.output.get("precision_escalated")),
               wall_s=time.perf_counter() - t0)
    say("mixed_path", part=name, **rec)
    return rec, x


def f64_plan(plan):
    """The f64 plan of a mixed one: the same symbolic phase (``analyze``
    makes it with mixed_precision=False unless the GRIDMF budget's leaf
    choice differs, which the callers check), 2 refinement rounds."""
    import dataclasses
    return dataclasses.replace(plan, mixed32=False, refine_steps=2,
                               symmetric_values=False)


def mixed_pair(name, s, mat, params, b, held="all", warm=2, cold64=True):
    """One mixed_path case: the user's path (``user_run``), then the same
    plan's numeric phase at f32 and at f64 (``mixed_runs``): the factor
    bytes and peaks' ratios and x against the f64 route's. Returns the
    record and the f32 factors."""
    from russell_tpu_torch.sparse import VerifyLinSys
    t0 = time.perf_counter()
    user, x_user = user_run(f"{name}_user", s, mat, params, b)
    if user["precision_escalated"]:
        raise AssertionError(f"mixed {name}: escalated to f64 factors")
    plan, vals = s.plan, s._vals_full
    bt = torch.as_tensor(b, device="cuda")
    rel = VerifyLinSys.from_system(mat, x_user.cpu().numpy(),
                                   b).relative_error
    dtypes = {"factors": str(factor_dtype(s.fac)),
              "data": str(s.fac["data"].dtype), "x": str(x_user.dtype)}
    s.fac = None
    gc.collect()
    torch.cuda.empty_cache()
    mixed, fac, x = mixed_runs(f"{name}_mixed", plan, vals, bt, held=held,
                               warm=warm)
    out = {"blocks": fac.get("blocks")}
    del fac
    gc.collect()
    torch.cuda.empty_cache()
    full, fac, x64 = mixed_runs(f"{name}_f64", f64_plan(plan), vals, bt,
                                held=False, warm=warm, cold=cold64)
    del fac
    rec = {"n": plan.n, "user": user, "mixed": mixed, "f64": full,
           "dtypes": dtypes, "relative_error": rel,
           "x_rel_err_vs_f64": rel_x_err(x_user, x64),
           "factor_bytes_ratio": mixed["factor_bytes"] / full["factor_bytes"],
           "peak_ratio": mixed["peak_mem_bytes"] / full["peak_mem_bytes"],
           # the fastest warm run of each (a first solve may warm up)
           "warm_factorize_ratio": min(mixed["warm_factorize_s"]) / min(
               full["warm_factorize_s"]),
           "warm_solve_ratio": min(mixed["warm_solve_s"]) / min(
               full["warm_solve_s"]),
           "wall_s": time.perf_counter() - t0}
    say("mixed_path", part=name, **{k: v for k, v in rec.items()
                                    if k not in ("user", "mixed", "f64")})
    if not (rec["x_rel_err_vs_f64"] <= MIXED_X_RTOL and rel <= 1e-10
            and rec["factor_bytes_ratio"] <= MIXED_BYTES_RATIO
            and dtypes["factors"] in ("torch.float32", "torch.complex64")):
        raise AssertionError(f"mixed {name}: x error "
                             f"{rec['x_rel_err_vs_f64']}, relative error "
                             f"{rel}, bytes ratio "
                             f"{rec['factor_bytes_ratio']}")
    del x, x64, x_user, bt, vals
    gc.collect()
    torch.cuda.empty_cache()
    return rec, out


def mixed_gridmf(res):
    """laplacian_2d(MIXED_NPOINT) through LinSolver(GRIDMF) with f32
    factors (numerically symmetric values: FCG is open to it), against the
    same plan at f64; no escalation."""
    from russell_tpu_torch.sparse import (Genie, LinSolParams, LinSolver,
                                          factor, gridmf, samples)
    N = MIXED_NPOINT
    coo = samples.laplacian_2d(N)
    b = np.random.default_rng(SEED + 31).standard_normal(coo.nrow)
    s = LinSolver(Genie.GRIDMF, device="cuda")
    rec, _ = mixed_pair("gridmf_1000", s, coo, LinSolParams(
        grid=(N, N, 1), mixed_precision=True), b)
    # the f64 route's analyze would keep this plan: the first leaf fits
    # the budget at 8 bytes a value too
    if not (3 * gridmf.gridmf_store_gb(s.plan.gridmf_plan, 8)
            <= factor.GRIDMF_BUDGET_GB and not s.plan.gridmf_ooc
            and rec["user"]["symmetric_values"]):
        raise AssertionError("mixed GRIDMF 1000: the f64 plan would differ "
                             "or the values are not found symmetric")
    res["gridmf_1000"] = rec
    res["gj_inv_shapes"] = rec["mixed"]["held_shapes"]["gj_inv"]


def mixed_splu(res, lres=None):
    """laplacian_3d_50 through LinSolver(SPLU) with f32 factors: every f32
    splu_pairs, gather_rows and gj_inv launch of a factorization held to
    its plain version; the f64 run of the same plan beside it."""
    from russell_tpu_torch.sparse import (Genie, LinSolParams, LinSolver,
                                          samples)
    coo = samples.laplacian_3d(MIXED_SPLU_NPOINT)
    b = np.random.default_rng(SEED + 32).standard_normal(coo.nrow)
    s = LinSolver(Genie.SPLU, device="cuda")
    rec, out = mixed_pair("splu_3d_50", s, coo, LinSolParams(
        mixed_precision=True), b)
    for k in F32_KERNELS:
        if not rec["mixed"]["launches_f32_per_factorization"][k]:
            raise AssertionError(f"mixed SPLU 3d_50: {k}'s f32 build was "
                                 "not launched")
    if lres is not None and "splu_3d" in lres:
        rec["lin_solver_path_f64_warm_median_s"] = lres["splu_3d"][
            "warm_median_s"]
    res["splu_3d_50"] = rec
    res["splu_plan"] = s.plan
    res["splu_blocks"] = out["blocks"]


def mixed_genmf_complex(res):
    """irregular_geometric(MIXED_GENMF_N) with complex values through
    LinSolver(GENMF) with complex64 factors (f32 planes): x complex128,
    against the same plan with complex128 factors."""
    from russell_tpu_torch.sparse import (CooMatrix, Genie, LinSolParams,
                                          LinSolver, samples)
    coo = samples.irregular_geometric(MIXED_GENMF_N, seed=3)
    ii, jj, vv = coo.triplets()
    n = coo.nrow
    rng = np.random.default_rng(SEED + 33)
    cv = np.asarray(vv) + 0.3j * rng.standard_normal(len(vv))
    cb = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    ccoo = CooMatrix.from_arrays(n, n, ii, jj, cv)
    s = LinSolver(Genie.GENMF, device="cuda")
    rec, _ = mixed_pair("genmf_complex", s, ccoo, LinSolParams(
        mixed_precision=True), cb, held="once")
    # complex64 factors (f32 planes), complex128 entries and x
    if rec["dtypes"] != {"factors": "torch.float32",
                         "data": "torch.complex128", "x": "torch.complex128"}:
        raise AssertionError(f"mixed GENMF complex: dtypes {rec['dtypes']}")
    res["genmf_complex"] = rec


def dense_case(n, kappa, seed, symmetric):
    """An n x n dense system of condition ``kappa`` (singular values
    logspaced from 1), Q D Q^T symmetric or Q D Q2^T, in full storage."""
    from russell_tpu_torch.sparse import CooMatrix
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    q2 = q if symmetric else np.linalg.qr(rng.normal(size=(n, n)))[0]
    A = (q * np.logspace(0, np.log10(kappa), n)) @ q2.T
    if symmetric:
        A = 0.5 * (A + A.T)
    ii, jj = np.nonzero(np.ones((n, n)))
    return CooMatrix.from_arrays(n, n, ii, jj, A[ii, jj]), A


def mixed_escalation(res):
    """Dense systems through LinSolver(AUTO) (DENSE) with f32 factors:
    tests/test_lin_solver.py:670-687's n-60 system of condition 1e9,
    which f32 factors cannot precondition, so the first solve must
    refactorize at f64 once and later solves keep those factors; and two
    of condition 3e8 (kappa eps_f32 ~ 18: plain refinement stalls) on
    which a Krylov tier converges without escalating: symmetric (flexible
    CG) and unsymmetric (FGMRES)."""
    from russell_tpu_torch.sparse import (CooMatrix, Genie, LinSolParams,
                                          LinSolver, VerifyLinSys, factor)
    t0 = time.perf_counter()
    # the reference's case: Q D Q^T, not symmetrized
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(60, 60)))
    A = (q * np.logspace(0, 9, 60)) @ q.T
    ii, jj = np.nonzero(np.ones((60, 60)))
    coo = CooMatrix.from_arrays(60, 60, ii, jj, A[ii, jj])
    s = LinSolver(Genie.AUTO, device="cuda")
    s.factorize(coo, LinSolParams(mixed_precision=True))
    genie, mixed = s.plan.genie.value, s.plan.mixed32
    b = np.ones(60)
    t1 = time.perf_counter()
    x = s.solve(b)
    solve_s = time.perf_counter() - t1
    tiers = dict(factor.factor_solve.refinement)
    fac = s.fac
    escalated = s.stats.output.get("precision_escalated")
    x2 = s.solve(np.arange(1.0, 61.0))
    rec = {"genie": genie, "mixed_before": mixed,
           "precision_escalated": escalated, "first_solve_s": solve_s,
           "tiers_before_escalation": tiers,
           "factor_dtype_after": str(s.fac["lu"].dtype),
           "refactorized_again": s.fac is not fac,
           "relative_error": VerifyLinSys.from_system(
               coo, x.cpu().numpy(), b).relative_error,
           "second_finite": bool(torch.isfinite(x2).all())}
    if not (genie == "dense" and mixed and escalated is True
            and not s.plan.mixed32 and not rec["refactorized_again"]
            and rec["relative_error"] < 1e-10 and rec["second_finite"]):
        raise AssertionError(f"mixed dense escalation: {rec}")
    for name, kappa, sym, tier in (("fcg", 3e8, True, "cg"),
                                   ("fgmres", 3e8, False, "fgmres")):
        coo, _ = dense_case(60, kappa, 0, sym)
        s = LinSolver(Genie.AUTO, device="cuda")
        s.factorize(coo, LinSolParams(mixed_precision=True))
        x = s.solve(b)
        r = {"kappa": kappa, "symmetric_values": s.plan.symmetric_values,
             "tiers": dict(factor.factor_solve.refinement),
             "precision_escalated": bool(
                 s.stats.output.get("precision_escalated")),
             "relative_error": VerifyLinSys.from_system(
                 coo, x.cpu().numpy(), b).relative_error}
        rec[f"dense_{name}"] = r
        if (r["precision_escalated"] or not r["tiers"][tier]
                or r["symmetric_values"] is not sym
                or not r["relative_error"] < 1e-10):
            raise AssertionError(f"mixed dense {name}: {r}")
    rec["wall_s"] = time.perf_counter() - t0
    say("mixed_path", part="dense_escalation", **rec)
    res["dense_escalation"] = rec


def mixed_ooc(res):
    """laplacian_3d(MIXED_OOC_NPOINT), hint (N, N, N), out of core (the
    budget under its store) with f32 factors against the same plan at f64:
    the host stores' bytes (f32 half f64's), walls, x against the f64
    route's."""
    from russell_tpu_torch.sparse import (Genie, LinSolParams, LinSolver,
                                          factor, samples)
    N = MIXED_OOC_NPOINT
    coo = samples.laplacian_3d(N)
    b = np.random.default_rng(SEED + 34).standard_normal(coo.nrow)
    budget = factor.GRIDMF_BUDGET_GB
    try:
        factor.GRIDMF_BUDGET_GB = 1e-9
        s = LinSolver(Genie.GRIDMF, device="cuda")
        # one warm run a precision: pinning the host stores sets the walls
        rec, _ = mixed_pair(f"ooc_3d_{N}", s, coo, LinSolParams(
            grid=(N, N, N), mixed_precision=True), b, held="once", warm=1,
            cold64=False)
        if not s.plan.gridmf_ooc:
            raise AssertionError("mixed OOC: the plan is in core")
    finally:
        factor.GRIDMF_BUDGET_GB = budget
    res[f"ooc_3d_{N}"] = rec


def f32_kernel_entries(res):
    """The kernels line's entries of the three f32 builds: each against its
    plain version and timed (device time back to back) at the mixed path's
    shapes, beside its bound at 4 bytes a value: splu_pairs and gather_rows
    on the SPLU laplacian_3d_50 plan's row with the most pairs (be 32, the
    factorization's own f32 blocks), gj_inv over the base calls of the
    GRIDMF 1000 f32 factorization (summed)."""
    from russell_tpu_torch.sparse import splu
    t0 = time.perf_counter()
    sp = res["splu_plan"].splu_plan
    pk = sp.packed
    dev = torch.device("cuda")
    dp = splu._device_plan(sp, dev)
    r = named_rows(sp, dp)[0]["argmax_pairs"]
    _, ln, _, npair, _, n_chunks, _ = dp["rows"][r]
    be = sp.b
    blocks = res["splu_blocks"]
    args = (blocks, dp["pair_l"][r, :npair], dp["pair_u"][r, :npair],
            dp["pair_seg"][r, :npair], dp["work"][r], ln, be)
    got = splu.splu_pairs(*args)
    want = splu._splu_pairs_plain(*args[:4], ln, be)
    err, _ = assert_close("splu_pairs f32", got, want)
    tiles = np.unique(np.concatenate([pk["pair_l"][r, :npair],
                                      pk["pair_u"][r, :npair]])).size
    b_ms, b_by = bound(4 * be * be * (tiles + ln) + 4 * (2 * npair + 2 * ln)
                       + 16 * n_chunks, 2 * npair * be ** 3)
    # the f64 builds at the same shapes, on the same values widened
    wide = blocks.double()
    args64 = (wide,) + args[1:]
    out = {"splu_pairs": {
        "max_abs_err": err, "ms": time_ms(lambda: splu.splu_pairs(*args)),
        "f64_build_ms": time_ms(lambda: splu.splu_pairs(*args64)),
        "plain_ms": time_ms(lambda: splu._splu_pairs_plain(*args[:4], ln,
                                                           be)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shapes": f"laplacian_3d_50 mixed SPLU row {r}: {ln} lanes, "
                  f"{npair} pairs, be {be}"}}
    idx = dp["dinv"][r, :ln]
    if not torch.equal(splu.gather_rows(blocks, idx), blocks[idx]):
        raise AssertionError("gather_rows f32 differs from blocks[idx]")
    b_ms, b_by = bound(4 * be * be * (torch.unique(idx).numel() + ln)
                       + 4 * ln, 0)
    out["gather_rows"] = {
        "max_abs_err": 0.0, "ms": time_ms(lambda: splu.gather_rows(blocks,
                                                                   idx)),
        "f64_build_ms": time_ms(lambda: splu.gather_rows(wide, idx)),
        "plain_ms": time_ms(lambda: splu._gather_rows_plain(blocks, idx)),
        "library_ms": time_ms(lambda: torch.index_select(blocks, 0, idx)),
        "bound_ms": b_ms, "bound_by": b_by,
        "shapes": f"laplacian_3d_50 mixed SPLU row {r}: {ln} rows of "
                  f"{be * be} f32"}
    calls = collections.Counter({tuple(s): c for s, c in
                                 res["gj_inv_shapes"]})
    delta = torch.tensor(1e-6, dtype=torch.float32, device=dev)
    del wide, args64
    ms = plain_ms = lib_ms = ms64 = 0.0
    nbytes = flops = 0
    # every launch at these shapes was held to the plain version in the
    # GRIDMF run (its record: max_abs_err, logdet_max_rel_err)
    held = res["gridmf_1000"]["mixed"]["held_to_plain"]["gj_inv"]
    for (w, m), c in sorted(calls.items()):
        D = gj_inputs(w, m, w + m).to(torch.float32)
        # a few calls a shape: 18 shapes, the plain version ~40 ms a call
        ms += c * time_ms(lambda: splu._gj_inv(D, delta), reps=5, warmup=1)
        D64 = D.double()
        ms64 += c * time_ms(lambda: splu._gj_inv(D64, delta), reps=5,
                            warmup=1)
        del D64
        plain_ms += c * time_ms(lambda: splu._gj_inv_plain(D, delta),
                                reps=1, warmup=1)
        lib_ms += c * time_ms(lambda: torch.linalg.inv_ex(D), reps=5,
                              warmup=1)
        nbytes += c * (8 * w * m * m + 16 * w)
        flops += c * 2 * m ** 3 * w
        del D
    b_ms, b_by = bound(nbytes, flops)
    out["gj_inv"] = {
        "max_abs_err": held["max_abs_err"],
        "logdet_max_rel_err": held["logdet_max_rel_err"], "ms": ms,
        "f64_build_ms": ms64,
        "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
        "bound_by": b_by,
        "shapes": "the base calls of the laplacian_2d 1000 mixed GRIDMF "
                  f"factorization, summed: {sum(calls.values())} calls, "
                  f"{len(calls)} shapes"}
    say("mixed_path", part="f32_kernels", wall_s=time.perf_counter() - t0,
        **out)
    return out


def phase_mixed_path(lres=None):
    """LinSolver(mixed_precision=True) on the card: GRIDMF laplacian_2d
    1000 (the FCG tier) against the f64 route, SPLU laplacian_3d_50 with
    every f32 kernel launch held to its plain version, complex GENMF
    (complex64 factors, complex128 x), the kappa-1e9 dense system's one
    escalation, and a 3-D GRIDMF grid out of core at half the host bytes;
    then the f32 builds' kernels-line entries. Every f32 build must be
    launched in the phase (counts set to 0 at its start)."""
    t0 = time.perf_counter()
    reset_launch_counts()
    HELD_F32[0] = {}
    res = {}
    mixed_escalation(res)
    mixed_gridmf(res)
    mixed_splu(res, lres)
    mixed_genmf_complex(res)
    mixed_ooc(res)
    launches = {k: v - HELD_F32[0].get(k, 0)
                for k, v in f32_counts().items()}
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"mixed_path: {k}'s f32 build was not "
                                 "launched")
    res["launches_f32"] = launches
    res["kernels"] = f32_kernel_entries(res)
    del res["splu_plan"], res["splu_blocks"]
    res["wall_s"] = time.perf_counter() - t0
    say("mixed_path", part="done", wall_s=res["wall_s"],
        launches_f32=launches)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def mixed_entries(mres):
    """The f32 builds' entries on the kernels line."""
    src = {"splu_pairs": "russell_tpu/sparse/splu.py:561",
           "gather_rows": "russell_tpu/sparse/splu.py:634",
           "gj_inv": "russell_tpu/sparse/splu.py:476 (plain XLA)"}
    return [{"name": f"{k}_f32", "route": "cuda",
             "source": f"russell_tpu_torch/csrc/{k}.cu", "replaces": src[k],
             "launches": mres["launches_f32"][k], **mres["kernels"][k]}
            for k in F32_KERNELS]


def walled(name, fn, *args):
    """``fn(*args)``, then one line with its wall (each phase's share of
    the smoke's time limit)."""
    t = time.perf_counter()
    out = fn(*args)
    say("phase_wall", name=name, wall_s=time.perf_counter() - t)
    return out


def main():
    t_start = time.perf_counter()
    walled("device", phase_device)
    # host-only work beside the card's phases: the SuperLU oracles of
    # lin_solver_path and the examples' CPU run of examples_path
    oracles = start_oracles()
    cpu = start_examples_cpu()
    try:
        main_phases(t_start, oracles, cpu)
    finally:
        stop_oracles(oracles)
        stop_examples_cpu(cpu)


def main_phases(t_start, oracles, cpu):
    walled("build", phase_build)
    plan = brusselator_plan(NPOINT)
    plan_rows = len(plan.splu_plan.packed["t0"])
    say("plan", npoint=NPOINT, ndim=plan.n, nblk=plan.splu_plan.nblk,
        rows=plan_rows, TL=plan.splu_plan.packed["TL"],
        C=int(plan.splu_plan.packed["pair_l"].shape[1]))
    walled("warmup", phase_warmup)
    kres = walled("kernels", phase_kernels, plan)
    walled("van_der_pol", phase_van_der_pol)
    walled("brusselator_small", phase_brusselator_small)
    walled("gridmf_small", phase_gridmf_small)
    sol, y, runs = walled("main_path", phase_main_path, plan_rows)
    splu_y = y.clone()
    walled("layers", phase_layers, sol, y)
    del sol, y
    torch.cuda.empty_cache()
    gruns, gridmf_y = walled("gridmf_main_path", phase_gridmf_main_path,
                             runs["warm"]["counters"], splu_y)
    splu_host = {"counters": runs["warm"]["counters"], "y": splu_y.cpu(),
                 "wall_s": runs["warm"]["wall_s"]}
    gridmf_host = {"counters": gruns[-1]["counters"], "y": gridmf_y,
                   "warm_median_s": statistics.median(
                       r["wall_s"] for r in gruns[1:])}
    del splu_y
    torch.cuda.empty_cache()
    gplans = walled("gridmf_layers", phase_gridmf_layers)
    gres = walled("gj_inv", phase_gj_inv, plan, gplans)
    del gplans
    rep = walled("replay", phase_replay, plan)
    walled("ode_samples", phase_ode_samples)
    erk_recs, erk_ys = walled("erk_path", phase_erk_path)
    erk_host = {(r["method"], r["npoint"]): {
        "counters": r["counters"], "wall_s": r["wall_s"],
        "y": erk_ys[(r["method"], r["npoint"])]} for r in erk_recs}
    walled("bweuler_path", phase_bweuler_path)
    walled("dense_factor", phase_dense_factor)
    walled("bsr_kernels", phase_bsr_kernels)
    bsr_launches, bres = walled("bsr_path", phase_bsr_path)
    cres = walled("bsr_complex", phase_bsr_complex)
    fres = walled("fused_path", phase_fused_path, gridmf_host, splu_host,
                  erk_host)
    lres = walled("lin_solver_path", phase_lin_solver_path, oracles)
    say("superlu_pool", **stop_oracles(oracles))
    pres = walled("pde_path", phase_pde_path)
    walled("nonlin_path", phase_nonlin_path)
    labres = walled("lab_path", phase_lab_path)
    stres = walled("stat_tensor_path", phase_stat_tensor_path,
                   fres["gridmf_129"]["counters"])
    parres = walled("parallel_path", phase_parallel_path)
    gc.collect()
    torch.cuda.empty_cache()
    ores = walled("ooc_path", phase_ooc_path)
    gc.collect()
    torch.cuda.empty_cache()
    eres = walled("examples_path", phase_examples_path, cpu)
    mres = walled("mixed_path", phase_mixed_path, lres)
    src = {"splu_pairs": ("russell_tpu_torch/csrc/splu_pairs.cu",
                          "russell_tpu/sparse/splu.py:561"),
           "gather_rows": ("russell_tpu_torch/csrc/gather_rows.cu",
                           "russell_tpu/sparse/splu.py:634"),
           "bsr_spmv": ("russell_tpu_torch/csrc/bsr_spmv.cu",
                        "russell_tpu/sparse/kernels.py:106"),
           "bsr_spmm": ("russell_tpu_torch/csrc/bsr_spmm.cu",
                        "russell_tpu/sparse/kernels.py:186"),
           "spgemm_blocks": ("russell_tpu_torch/csrc/spgemm_blocks.cu",
                             "russell_tpu/sparse/kernels.py:306"),
           "gj_inv": ("russell_tpu_torch/csrc/gj_inv.cu",
                      "russell_tpu/sparse/splu.py:476 (plain XLA)")}
    kernels = []
    b = plan.splu_plan.b
    for name, row in (("splu_pairs", "argmax_pairs"),
                      ("gather_rows", "argmax_len")):
        # one factorize row: the real (b) and complex (2b) states summed
        res = [kres[(name, row, be)] for be in (b, 2 * b)]
        lib = [r[3] for r in res]
        by = max(res, key=lambda r: r[4])[5]
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1],
            "launches": runs["warm"]["launches"][name],
            "max_abs_err": max(v[0] for k, v in kres.items()
                               if k[0] == name),
            "ms": sum(r[1] for r in res),
            "ms_cold_l2": sum(r[6] for r in res),
            "plain_ms": sum(r[2] for r in res),
            "library_ms": None if None in lib else sum(lib),
            "bound_ms": sum(r[4] for r in res), "bound_by": by,
            "replay_ms_per_factorize_pair": rep[f"{name}_ms"],
            "fused_path": fused_entry(fres, name),
            "launches_lin_solver_path_splu_3d_per_factorization": lres[
                "splu_3d"]["launches_per_factorization"][name],
            "lin_solver_path_splu_3d_held_to_plain": lres["splu_3d"][
                "held_to_plain"][name],
            "pde_path": pde_entry(pres, name),
            "parallel_path": parallel_entry(parres, name),
            "batch": batch_entry(fres, name),
            "shapes": f"npoint-129 SPLU factorize row ({row}), b 32 + 2b 64"})
    for name, res in bres.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": bsr_launches[name],
            **res, "shapes": f"npoint-{NPOINT_BSR} Brusselator Jacobian",
            "fused_path": fused_entry(fres, name),
            "complex128": {k: cres[name][k] for k in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")}})
    kernels.append({
        "name": "gj_inv", "route": "cuda", "source": src["gj_inv"][0],
        "replaces": src["gj_inv"][1],
        "launches": gruns[-1]["gj_inv_launches"], **gres,
        "launches_splu_main_path": runs["warm"]["launches"]["gj_inv"],
        "fused_path": fused_entry(fres, "gj_inv"),
        "lin_solver_path": {
            "genmf_264k_launches_per_factorization": lres["genmf_264k"][
                "gj_inv_launches"],
            "genmf_264k_ms_per_factorization": lres["genmf_264k"][
                "gj_inv_device_ms"],
            "genmf_264k_complex_launches_per_factorization": lres[
                "genmf_264k_complex"]["gj_inv_launches"],
            "genmf_264k_complex_ms_per_factorization": lres[
                "genmf_264k_complex"]["gj_inv_device_ms"],
            "splu_3d_launches_per_factorization": lres["splu_3d"][
                "launches_per_factorization"]["gj_inv"],
            "held_to_plain": {part: lres[part]["held_to_plain"]["gj_inv"]
                              for part in ("genmf_264k",
                                           "genmf_264k_complex",
                                           "splu_3d")},
            "genmf_264k_shapes_logdet_max_rel_err": lres["genmf_264k"][
                "gj_inv_shapes_logdet_max_rel_err"]},
        "pde_path": pde_entry(pres, "gj_inv"),
        "stat_tensor_path": {
            "brusselator_pde_cli_launches": stres["cli"]["brusselator_pde"][
                "gj_inv_launches"],
            "trace_kernel_events": stres["cli"]["trace"][
                "gj_inv_kernel_events"]},
        "parallel_path": parallel_entry(parres, "gj_inv"),
        "batch": batch_entry(fres, "gj_inv"),
        "ooc_path": ooc_entry(ores),
        "shapes": f"the base calls of one npoint-{NPOINT} GRIDMF factorize "
                  "pair, summed (inv_block: per factorize pair, the "
                  "top-level pivot blocks)"})
    kernels.append(jacobi_entry(labres))
    kernels.append({
        **fres["lane_pow"],
        "launches": fres["gridmf_129"]["launches_cold_run"]["lane_pow"],
        "fused_path": fused_entry(fres, "lane_pow"),
        "shapes": "one lane (the fused solves), 64 lanes (solve_batch)"})
    for k in kernels:
        if k["name"] in EXAMPLES_KERNELS:
            k["examples_path"] = examples_entry(eres, k["name"])
    kernels += mixed_entries(mres)
    say("done", wall_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def bsr_ab_times():
    """bsr_matvec and bsr_matmat (m = SPMM_M) at 8x128 and spgemm (A·A) at
    16x16 on the npoint-513 Jacobian through the public entry points of
    this process's package: the host seconds of the first call of each on a
    new matrix (for spgemm after its spgemm_plan) and of the first
    bsr_matvec and spgemm after an in-place update of the blocks (each a
    product plus, in a package that derives a layout from the blocks, its
    build), after each was called once on the npoint-9 Jacobian so that
    none pays for loading the kernels; then each timed back to back
    (``time_ms``)."""
    from russell_tpu_torch.sparse import (bsr_from_coo, bsr_matmat,
                                          bsr_matvec, spgemm, spgemm_plan)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    small_coo = brusselator_jacobian(9)
    small = bsr_from_coo(small_coo, 8, 128, dev)
    bsr_matvec(small, torch.ones(small.n_cols, dtype=torch.float64,
                                 device=dev))
    bsr_matmat(small, torch.ones((small.n_cols, SPMM_M), dtype=torch.float64,
                                 device=dev))
    small = bsr_from_coo(small_coo, 16, 16, dev)
    spgemm(spgemm_plan(small, small), small, small)
    coo = brusselator_jacobian(NPOINT_BSR)
    x = torch.as_tensor(rng.standard_normal(coo.ncol), device=dev)
    X = torch.as_tensor(rng.standard_normal((coo.ncol, SPMM_M)), device=dev)
    bsr8 = bsr_from_coo(coo, 8, 128, dev)
    y, first_matvec_s = first_call_s(lambda: bsr_matvec(bsr8, x))
    Y, first_matmat_s = first_call_s(lambda: bsr_matmat(bsr8, X))
    rec = {"bsr_matvec_ms": time_ms(lambda: bsr_matvec(bsr8, x)),
           "bsr_matmat_ms": time_ms(lambda: bsr_matmat(bsr8, X)),
           "bsr_first_matvec_s": first_matvec_s,
           "bsr_first_matmat_s": first_matmat_s,
           "y_sum": float(y.sum()), "Y_sum": float(Y.sum())}
    bsr8.blocks.mul_(1.0)
    _, rec["bsr_updated_matvec_s"] = first_call_s(
        lambda: bsr_matvec(bsr8, x))
    del bsr8
    torch.cuda.empty_cache()
    bsr16 = bsr_from_coo(coo, 16, 16, dev)
    plan = spgemm_plan(bsr16, bsr16)
    (C, _), rec["spgemm_first_s"] = first_call_s(
        lambda: spgemm(plan, bsr16, bsr16))
    rec["C_sum"] = float(C.sum())
    del C
    rec["spgemm_ms"] = time_ms(lambda: spgemm(plan, bsr16, bsr16))
    bsr16.blocks.mul_(1.0)
    _, rec["spgemm_updated_s"] = first_call_s(
        lambda: spgemm(plan, bsr16, bsr16))
    return rec


def gridmf_replay(npoint):
    """One GRIDMF factorize pair at ``npoint`` (the leaf AUTO picks) as
    ``gridmf_pair_record`` measures it, under keys of the npoint."""
    plan, vr, vc, _ = gridmf_setup(npoint)
    rec = gridmf_pair_record(plan, vr, vc)
    del plan, vr, vc
    torch.cuda.empty_cache()
    return {f"gridmf_{npoint}_{k}": rec[f"factorize_pair_{k}"] for k in (
        "device_launches", "device_ms", "profiled_wall_ms",
        "wall_median_ms")}


def default_path_walls(warm_runs=3):
    """``default_path_runs``: the cold wall, the warm walls, their median
    and spread, and the last run's counters."""
    recs = [rec for rec, _, _ in default_path_runs(warm_runs)]
    warm = [r["wall_s"] for r in recs[1:]]
    return {"default_cold_wall_s": recs[0]["wall_s"],
            "default_warm_walls_s": warm,
            "default_warm_median_s": statistics.median(warm),
            "default_warm_spread_s": max(warm) - min(warm),
            "default_counters": recs[-1]["counters"]}


def main_replay():
    """--replay [--tree DIR]: one line, the replay of this package (or
    DIR's) on the npoint-129 SPLU factorize pair, one GRIDMF factorize pair
    at npoint 129 and 513, the default path's walls at npoint 129, then its
    BSR SpMV, SpMM and SpGEMM times on the npoint-513 Jacobian."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    rec = replay(replay_setup())
    torch.cuda.empty_cache()
    for npoint in (NPOINT, NPOINT_BSR):
        rec.update(gridmf_replay(npoint))
    rec.update(default_path_walls())
    torch.cuda.empty_cache()
    print(json.dumps({**rec, **bsr_ab_times()}), flush=True)


def main_ab(parent, rounds):
    """--ab PARENT [ROUNDS]: ``main_replay`` with the parent tree's package
    (``git archive`` of the parent commit unpacked at PARENT) and with this
    tree's, each in its own process, in turns P C C P, ROUNDS times, on one
    card; then the medians of each number and the ratios change /
    parent."""
    phase_device()
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(parent), "change": here}
    runs = {"parent": [], "change": []}
    for which in ("parent", "change", "change", "parent") * rounds:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--replay", "--tree",
             trees[which]], cwd=trees[which], capture_output=True,
            text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"replay of {which} failed:\n"
                               f"{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        if not rec["package"].startswith(trees[which]):
            raise AssertionError(f"{which} ran {rec['package']}")
        say("ab_replay", tree=which, **rec)
        runs[which].append(rec)
    keys = ("splu_pairs_ms", "gather_rows_ms", "gj_inv_ms",
            "device_busy_ms", "device_launches", "profiled_wall_s",
            *(f"gridmf_{n}_{k}" for n in (NPOINT, NPOINT_BSR) for k in (
                "device_launches", "device_ms", "profiled_wall_ms",
                "wall_median_ms")),
            "default_cold_wall_s", "default_warm_median_s",
            "default_warm_spread_s",
            "bsr_matvec_ms", "bsr_matmat_ms",
            "bsr_first_matvec_s", "bsr_first_matmat_s",
            "bsr_updated_matvec_s", "spgemm_ms", "spgemm_first_s",
            "spgemm_updated_s")
    med = {which: {k: statistics.median(r[k] for r in recs) for k in keys}
           for which, recs in runs.items()}
    p, c = med["parent"], med["change"]

    def break_even(ms, first_s):
        """Calls on one matrix (one layout build, whose cost is in the
        first call ``first_s``) after which the change has spent less time
        than the parent: 0 if its first call is no dearer."""
        saved_ms = p[ms] - c[ms]
        extra_ms = 1e3 * (c[first_s] - p[first_s])
        if extra_ms <= 0:
            return 0.0
        return extra_ms / saved_ms if saved_ms > 0 else None

    say("ab", order="P C C P", rounds=rounds, median=med,
        counters={w: [r["default_counters"] for r in recs]
                  for w, recs in runs.items()},
        bsr_matvec_break_even_products=break_even("bsr_matvec_ms",
                                                  "bsr_first_matvec_s"),
        bsr_matvec_break_even_after_update=break_even(
            "bsr_matvec_ms", "bsr_updated_matvec_s"),
        spgemm_break_even_calls=break_even("spgemm_ms", "spgemm_first_s"),
        spgemm_break_even_after_update=break_even("spgemm_ms",
                                                  "spgemm_updated_s"),
        ratio={k: c[k] / p[k] for k in keys if p[k]})


def banded_walls():
    """--banded [--tree DIR]: one line, the warm walls of BANDED (this
    package's or DIR's) as the main run drives it: laplacian_2d_317
    factorized and solved through cyclic reduction and through the
    sequential scan (medians of LS_WARM_RUNS after a cold call, with the
    relative residual), and two Bratu-2-D continuations at BRATU_BIG
    (BANDED, BCR; their solve walls and counters)."""
    import russell_tpu_torch
    from russell_tpu_torch import nonlin
    from russell_tpu_torch.sparse import Genie, VerifyLinSys, factor, samples
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    coo = samples.laplacian_2d(LAPLACIAN_2D_NPOINT)
    ii, jj, vv = coo.triplets()
    b = np.random.default_rng(SEED + 1).standard_normal(coo.nrow)
    vt = torch.as_tensor(vv, device="cuda")
    bt = torch.as_tensor(b, device="cuda")
    rec = {"package": os.path.dirname(russell_tpu_torch.__file__)}
    for kernel in ("bcr", "scan"):
        plan = factor.analyze(coo.nrow, ii, jj, genie=Genie.BANDED,
                              banded_kernel=kernel)

        def fact(plan=plan):
            fac = factor.numeric_factorize(plan, vt)
            float(fac["min_pivot"])
            return fac
        fac = fact()
        walls = []
        for _ in range(LS_WARM_RUNS):
            t0 = time.perf_counter()
            fac = fact()
            walls.append(time.perf_counter() - t0)
        x = factor.factor_solve(plan, fac, bt)
        rec[f"{kernel}_factorize_s"] = statistics.median(walls)
        rec[f"{kernel}_solve_s"] = timed_solves(
            lambda: factor.factor_solve(plan, fac, bt))
        rec[f"{kernel}_relative_error"] = VerifyLinSys.from_system(
            coo, x.cpu().numpy(), b).relative_error
        del fac, x, plan
        gc.collect()
        torch.cuda.empty_cache()
    walls, counts = [], []
    for _ in range(2):
        _, status, cnt, _, wall, _, _, _, _ = continuation(
            "bratu_2d_fdm", (BRATU_BIG,), nonlin.Method.ARCLENGTH,
            lambda m: nonlin.Stop.max_comp_u(m, 6.0),
            nonlin.DeltaLambda.auto(0.5))
        if not status.success():
            raise AssertionError(f"bratu_2d_{BRATU_BIG}: {status}")
        walls.append(wall)
        counts.append(dict(zip(NONLIN_COUNTERS, cnt)))
    rec.update(bratu_wall_s=walls, bratu_counters=counts)
    print(json.dumps(rec), flush=True)


def lu_library_times():
    """torch's batched LU and its solves at the shapes of cyclic
    reduction's first level on laplacian_2d_317 (256 blocks of 320 x 320)
    and of the sequential scan (one block): ``lu_factor_ex`` under torch's
    default library choice and under cuSOLVER, and ``lu_solve`` (getrs)
    against the stored row order's gather and two ``solve_triangular``
    (``bcr.lu_solve``), for one column and for 320; device ms
    (``time_ms``)."""
    from russell_tpu_torch.sparse import bcr
    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for m in (256, 1):
        A = torch.randn((m, 320, 320), generator=g, dtype=torch.float64,
                        device="cuda") + 320 * torch.eye(
                            320, dtype=torch.float64, device="cuda")
        for lib in ("default", "cusolver"):
            prev = torch.backends.cuda.preferred_linalg_library()
            torch.backends.cuda.preferred_linalg_library(lib)
            try:
                out[f"lu_{m}_{lib}_ms"] = time_ms(
                    lambda: torch.linalg.lu_factor_ex(A))
            finally:
                torch.backends.cuda.preferred_linalg_library(prev)
        lu, piv = bcr.lu_factor(A)
        perm = bcr.lu_perm(lu, piv)
        out[f"lu_perm_{m}_ms"] = time_ms(lambda: bcr.lu_perm(lu, piv))
        for r in (1, 320):
            B = torch.randn((m, 320, r), generator=g, dtype=torch.float64,
                            device="cuda")
            want = torch.linalg.lu_solve(lu, piv, B)
            got = bcr.lu_solve(lu, perm, B)
            out[f"solve_{m}x{r}_getrs_ms"] = time_ms(
                lambda: torch.linalg.lu_solve(lu, piv, B))
            out[f"solve_{m}x{r}_gather_trsm_ms"] = time_ms(
                lambda: bcr.lu_solve(lu, perm, B))
            out[f"solve_{m}x{r}_max_abs_diff"] = float(
                (got - want).abs().max())
    return out


def main_banded_ab(parent, rounds):
    """--banded-ab PARENT [ROUNDS]: ``banded_walls`` with the parent
    tree's package (a ``git archive`` of the parent commit unpacked at
    PARENT) and with this tree's, each in its own process, in turns P C C
    P, ROUNDS times, on one card; then the medians of each wall, the
    ratios change / parent, and ``lu_library_times``."""
    phase_device()
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(parent), "change": here}
    runs = {"parent": [], "change": []}
    for which in ("parent", "change", "change", "parent") * rounds:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--banded", "--tree",
             trees[which]], cwd=trees[which], capture_output=True,
            text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"banded walls of {which} failed:\n"
                               f"{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        if not rec["package"].startswith(trees[which]):
            raise AssertionError(f"{which} ran {rec['package']}")
        say("banded_walls", tree=which, **rec)
        runs[which].append(rec)
    keys = ("bcr_factorize_s", "bcr_solve_s", "scan_factorize_s",
            "scan_solve_s")
    med = {which: {k: statistics.median(r[k] for r in recs) for k in keys}
           for which, recs in runs.items()}
    for which, recs in runs.items():
        med[which]["bratu_wall_s"] = statistics.median(
            w for r in recs for w in r["bratu_wall_s"])
    p, c = med["parent"], med["change"]
    say("banded_ab", order="P C C P", rounds=rounds, median=med,
        ratio={k: c[k] / p[k] for k in p if p[k]},
        bratu_counters_equal=len({json.dumps(r["bratu_counters"][0])
                                  for recs in runs.values()
                                  for r in recs}) == 1,
        lu_library=lu_library_times())


def fused_memory_case(genie, npoint, lanes, capture=True):
    """The memory of one fused Radau5 loop (the bench.py configuration at
    ``npoint``, AUTO or ``genie`` by name, ``lanes`` spread lanes) through
    its set-up (``start``), warm-up, capture and first run, each with the
    allocator's counters from a reset peak: allocated and reserved bytes
    (current and peak), alloc retries (cached blocks returned to the card
    to serve an allocation) and the reserved bytes by (pool, stream) after
    the warm-up and after the capture, with what the capture's memory
    check read (the warm-up's reservation and retries, the free bytes) and
    its refusal, if it refused; without ``capture`` the warm-up only. One
    line."""
    from russell_tpu_torch.ode import Method, OdeSolver, Params, samples
    from russell_tpu_torch.sparse.enums import Genie

    def stats():
        st = torch.cuda.memory_stats()
        return {"allocated": st["allocated_bytes.all.current"],
                "allocated_peak": st["allocated_bytes.all.peak"],
                "reserved": st["reserved_bytes.all.current"],
                "reserved_peak": st["reserved_bytes.all.peak"],
                "alloc_retries": st["num_alloc_retries"]}

    def by_stream():
        out = collections.Counter()
        for sg in torch.cuda.memory_snapshot():
            out[f"pool {sg.get('segment_pool_id')} stream {sg['stream']}"] += \
                sg["total_size"]
        return dict(out)

    system, t0, y0, _ = samples.brusselator_pde(ALPHA, npoint)
    params = Params(Method.RADAU5)
    params.set_tolerances(1e-4, 1e-4)
    if genie != "auto":
        params.newton.genie = Genie[genie.upper()]
    sol = OdeSolver(params, system, "cuda")
    fn = sol._fused_for(lanes)
    y0s = torch.as_tensor(spread_lanes(y0, lanes) if lanes > 1
                          else np.asarray(y0)[None], device="cuda")
    rec = {"genie": genie, "npoint": npoint, "lanes": lanes}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn.start(t0, y0s, 1.0, min(params.step.h_ini, 1.0))
    torch.cuda.synchronize()
    rec["start"] = stats()
    torch.cuda.reset_peak_memory_stats()
    fn.loop.warm_up()
    rec["warm_up"] = stats()
    rec["warm_up_by_stream"] = by_stream()
    gc.collect()
    torch.cuda.empty_cache()
    rec["free_before_capture"] = torch.cuda.mem_get_info()[0]
    rec.update(warmup_bytes=fn.loop.warmup_bytes,
               warmup_retries=fn.loop.warmup_retries)
    if capture:
        torch.cuda.reset_peak_memory_stats()
        try:
            fn.loop.capture(warm_up=False)
        except ValueError as e:
            rec.update(capture_free=fn.loop.capture_free, refused=str(e))
            say("fused_memory", **rec)
            return
        torch.cuda.synchronize()
        rec["capture_free"] = fn.loop.capture_free
        rec["capture"] = stats()
        rec["capture_by_stream"] = by_stream()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        fn.loop.run()
        torch.cuda.synchronize()
        rec["run_s"] = time.perf_counter() - t
        rec["run"] = stats()
    say("fused_memory", **rec)
    del fn, sol
    gc.collect()
    torch.cuda.empty_cache()


def base_sweep(bases=BASE_SWEEP, rounds=2):
    """The factorize pairs whose pivot inverses reach gj_inv (GRIDMF at
    npoint 129 and 513 at the leaf AUTO picks, 513 at leaf 16, SPLU at
    129) with ``splu.GJ_MAX_M`` set to each base of ``bases`` in turn,
    ``rounds`` times in alternating order: the device launches, device ms
    and profiled wall of one pair under the profiler and the median wall of
    three, which is how GJ_MAX_M was chosen."""
    from russell_tpu_torch.sparse import factor, splu
    default = splu.GJ_MAX_M
    setups = {"splu_129": lambda: replay_setup()}
    for name, npoint, leaf in (("gridmf_129", NPOINT, None),
                               ("gridmf_513", NPOINT_BSR, None),
                               ("gridmf_513_leaf16", NPOINT_BSR, 16)):
        setups[name] = (lambda npoint=npoint, leaf=leaf:
                        gridmf_setup(npoint, leaf)[:3])
    try:
        for name, setup in setups.items():
            plan, vr, vc = setup()
            order = list(bases)
            for rnd in range(rounds):
                for base in (order if rnd % 2 == 0 else order[::-1]):
                    splu.GJ_MAX_M = base

                    def pair():
                        return factor.numeric_factorize_pair(plan, vr, vc)
                    pair()
                    torch.cuda.synchronize()
                    walls = []
                    for _ in range(3):
                        t0 = time.perf_counter()
                        pair()
                        torch.cuda.synchronize()
                        walls.append(time.perf_counter() - t0)
                    n0 = gj_inv_launches()
                    ms, wall, launches = kernel_device_ms(pair)
                    say("base_sweep", pair=name, gj_max_m=base, round=rnd,
                        device_launches=launches,
                        gj_inv_launches=gj_inv_launches() - n0,
                        device_ms=sum(ms.values()),
                        gj_inv_ms=summed(ms, "gj_inv"),
                        gemm_ms=sum(v for k, v in ms.items()
                                    if "gemm" in k.lower()),
                        profiled_wall_ms=1e3 * wall,
                        wall_median_ms=1e3 * statistics.median(walls))
            del plan, vr, vc
            torch.cuda.empty_cache()
    finally:
        splu.GJ_MAX_M = default


def strip_sweep():
    """spgemm on the npoint-513 Jacobian (16x16, A·A) for each strip budget
    of STRIP_SWEEP (``kernels.SPGEMM_STRIP_BYTES``): the L2-cold and
    back-to-back times and the bits against the default budget's, which is
    how the budget was chosen."""
    from russell_tpu_torch.sparse import (bsr_from_coo, kernels, spgemm,
                                          spgemm_plan)
    bsr16 = bsr_from_coo(brusselator_jacobian(NPOINT_BSR), 16, 16,
                         torch.device("cuda"))
    plan = spgemm_plan(bsr16, bsr16)
    want = spgemm(plan, bsr16, bsr16)[0]
    most = kernels._device_plan(plan, want.device)["max_row_blocks"]
    b_ms = bound(*spgemm_work(plan, bsr16, bsr16))[0]
    default = kernels.SPGEMM_STRIP_BYTES
    try:
        for budget in STRIP_SWEEP:
            kernels.SPGEMM_STRIP_BYTES = budget
            same = torch.equal(spgemm(plan, bsr16, bsr16)[0], want)
            ms = cold_ms(lambda: spgemm(plan, bsr16, bsr16))
            say("strip_sweep", budget=budget, strip=kernels._strip_chunks(
                16, 16, most), ms=ms,
                ms_warm_l2=time_ms(lambda: spgemm(plan, bsr16, bsr16)),
                share=b_ms / ms, bit_identical=same)
            if not same:
                raise AssertionError(f"spgemm: budget {budget} changes the "
                                     "bits")
    finally:
        kernels.SPGEMM_STRIP_BYTES = default


if __name__ == "__main__":
    if "--replay" in sys.argv:
        main_replay()
    elif "--chunk-sweep" in sys.argv:
        phase_device()
        phase_build()
        chunk_sweep(brusselator_plan(NPOINT))
    elif "--strip-sweep" in sys.argv:
        phase_device()
        phase_build()
        strip_sweep()
    elif "--base-sweep" in sys.argv:
        phase_device()
        phase_build()
        base_sweep()
    elif "--lin-solver-path" in sys.argv:
        phase_device()
        phase_build()
        phase_lin_solver_path()
    elif "--pde-nonlin" in sys.argv:
        phase_device()
        phase_build()
        phase_pde_path()
        phase_nonlin_path()
    elif "--stat-tensor" in sys.argv:
        phase_device()
        phase_build()
        phase_stat_tensor_path()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    elif "--parallel" in sys.argv:
        phase_device()
        phase_build()
        phase_parallel_path()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    elif "--fused-batch" in sys.argv:
        phase_device()
        phase_build()
        fb = fused_batch_path({})
        print(json.dumps({"kernels": [
            {"name": k, "batch": batch_entry(fb, k)}
            for k in BATCHED_KERNELS]}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    elif "--lab" in sys.argv:
        phase_device()
        phase_build()
        lab_kernels = [jacobi_entry(phase_lab_path())]
        print(json.dumps({"kernels": lab_kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    elif "--examples" in sys.argv:
        phase_device()
        cpu = start_examples_cpu()
        try:
            phase_build()
            eres = phase_examples_path(cpu)
        finally:
            stop_examples_cpu(cpu)
        print(json.dumps({"kernels": [
            {"name": k, "examples_path": examples_entry(eres, k)}
            for k in EXAMPLES_KERNELS]}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    elif "--mixed-path" in sys.argv:
        phase_device()
        phase_build()
        print(json.dumps({"kernels": mixed_entries(phase_mixed_path())}),
              flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    elif "--ooc" in sys.argv:
        phase_device()
        phase_build()
        ores = phase_ooc_path()
        print(json.dumps({"kernels": [
            {"name": "gj_inv", "ooc_path": ooc_entry(ores)}]}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    elif "--fused-memory" in sys.argv:
        # GENIE:NPOINT:LANES[:warmup] ... (warm-up only: no capture)
        phase_device()
        for arg in sys.argv[sys.argv.index("--fused-memory") + 1:]:
            g, npt, ln, *only = arg.split(":")
            fused_memory_case(g, int(npt), int(ln), capture=not only)
    elif "--banded" in sys.argv:
        banded_walls()
    elif "--banded-ab" in sys.argv:
        i = sys.argv.index("--banded-ab")
        main_banded_ab(sys.argv[i + 1],
                       int(sys.argv[i + 2]) if len(sys.argv) > i + 2 else 1)
    elif "--ab" in sys.argv:
        i = sys.argv.index("--ab")
        main_ab(sys.argv[i + 1],
                int(sys.argv[i + 2]) if len(sys.argv) > i + 2 else 1)
    else:
        main()
