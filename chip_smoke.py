#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hyphy_tpu_torch``) on one card.

    python3 chip_smoke.py                    # every phase; FEL as `warmup fel` (capped fits)
    python3 chip_smoke.py --full-fit         # the same, with FEL's fits run to convergence
    python3 chip_smoke.py --precision-check  # phases 1-3, then FEL's fp32 vs fp64 site calls
    python3 chip_smoke.py --busted-check     # phases 1-3, then BUSTED uncapped in fp32 and fp64
    python3 chip_smoke.py --relax-check      # phases 1-3, then RELAX and aBSREL uncapped
    python3 chip_smoke.py --mesh             # phases 1-3, then phase 30 (the mesh) alone
    python3 chip_smoke.py --mesh-width       # phases 1-3, then FEL's and MEME's per-site
                                             # stages at full width, one card vs every card

Run from the root of a checkout; it builds the CUDA kernels from the
checkout's sources.  Phases, each of which fails the run if it fails:

  1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
  2. the build of every kernel source (one ``nvcc`` each) and of the host
     C++ sources (one ``g++`` each), all at once;
  3. every kernel against its plain PyTorch version on the card, at the
     main path's shapes (the protein evaluation's widest level, 20 states,
     among them) and at alignment and edge shapes, in fp32 and fp64, with
     times; then K1 summed over the 23 real level widths of the main path's
     tree, for the codon, the nucleotide and the protein pattern counts;
  4. the main path at full width — FEL on 1000 taxa x 2048 codons as a
     user runs it, ``python -m hyphy_tpu_torch warmup fel`` (L-BFGS capped
     at 3 iterations, Nelder-Mead at 32; ``fel`` uncapped with
     ``--full-fit``), called in-process: load -> GTR fit -> global MG94xREV
     fit -> per-site grid starts, alternative and null Nelder-Mead -> LRT
     and JSON, with the launch counts read around it, seconds per stage,
     Nelder-Mead iterations and ms per batched site evaluation (taken by
     wrapping the port's stage functions here), and the JSON checked;
  5. the likelihood at ``bench.py``'s parameter point in fp64 and fp32:
     against the JAX package's CPU fp64 value, with Taylor-route fp64
     propagators against the HyPhy binary's value, the card's pruning
     against the CPU's plain pruning on identical inputs, and times per
     evaluation;
  6. FEL's per-site objective at phase 4's MG94 fit and three points of
     the SRV start grid: fp64 Taylor and fp64 spectral on the card against
     the host on identical inputs, fp32 against fp64 Taylor on every
     pattern; then one batched evaluation of all 2048 patterns per route
     and the batched fp64 eigendecomposition alone, timed by CUDA events,
     the host clock and the profiler, beside their bounds;
  7. FEL with CHARSET partitions and multiple hits at full width: phase
     4's alignment written as a NEXUS of 2 CHARSETs of 1024 codons (one
     TREE each), ``[warmup] fel --multiple-hits Double+Triple
     --site-multihit Estimate`` through the CLI in-process — joint GTR and
     joint multi-hit MG94 fits, per-site fits with per-site 2H/3H rates —
     with seconds per stage, K1 launches per partition, peak memory and ms
     per batched site evaluation; the JSON checked; then the per-site
     objective with per-site delta/psi, card against host in fp64 Taylor;
  8. ``warmup fel --ci Yes --resample 10`` on 48 taxa x 128 codons
     (``random_tree_newick(48, SEED)``: the CI's evaluations are a fixed
     number of steps whose launches follow the tree's levels, so the run is
     cut in taxa; capped under ``--full-fit`` too), with the
     fused Nelder-Mead probes (``HYPHY_TPU_NM_FUSED=1``: at 128 sites an
     evaluation is host launch time): seconds of the CI and of the
     bootstrap apart, LB <= MLE <= UB, bootstrap p in multiples of 1/11;
  (after phase 6) the Nelder-Mead's fused four-probe body against its
     sequential probes on phase 6's objective at 128 sites:
     ms and launches per iteration, peak memory, results equal bit for bit;
  9. SLAC at full width: ``simulated_codon_alignment(1000, 2048, seed=11)``
     with omega = 5 at nine planted codons, through ``warmup slac
     --samples 5`` in-process: seconds per stage (load, GTR, MG94, joint
     reconstruction, counts, sampling), peak memory, K1 launches; the
     card's fp64 joint states against the host's on identical inputs
     (equal), root lnL within 1e-9 relative, fp32's share of equal states;
     the JSON (headers, finite tables, 2.5% <= median <= 97.5%);
 10. ``warmup simulate --replicates 2`` on phase 9's alignment: the
     replicates have its taxa and codons;
 11. MEME on phase 9's alignment cut to 64 codons, with the fused
     Nelder-Mead probes (the EBF's items grow
     with codons x tested branches), through ``warmup meme``: seconds per
     stage (FEL, candidates, alternative, null, EBF), the EBF's items and
     chunks, K1 launches, one batched mixture evaluation timed and
     profiled; the mixture site lnL card vs host (fp64 Taylor, 1e-9) and
     fp32 vs fp64 (0.03); the planted codons at p <= 0.1; the EBFs of the
     sites one chunk holds, and of 16 sites, held bit for bit between the
     chunks free memory gives and forced chunks of 997 items;
 12. FUBAR at full width on phase 9's alignment, ``warmup fubar --grid
     20``: seconds per stage (load, GTR, the two grid passes, the
     posterior), grid points per chunk, K1 launches, peak memory; pass 2's
     fp32 Taylor grid against fp64 spectral on four interior grid points
     (0.03 per pattern), two points folded into one call against each alone
     (equal) and against the one-set pruning (1e-5 relative), the posterior
     summing to 1, 7 of 9 planted codons at P[beta > alpha] >= 0.9;
 13. B-STILL on phase 9's alignment cut to 256 codons, ``warmup b-still
     --grid 20``: seconds, K1 launches, the JSON, finite EBFs;
 14. contrast-FEL (G = 3) at 1000 taxa, with the fused Nelder-Mead
     probes, on a second alignment cut to 512
     codons: two disjoint ~250-leaf clades of the same tree labelled FG and
     REF, omega = 5 on FG only at the nine planted codons, ``warmup
     contrast-fel --branch-set FG --branch-set REF``: seconds per stage, ms
     per batched site evaluation, one profiled, peak memory, K1 launches;
     all but two of the seven planted codons below 512 at p <= 0.1, the
     per-site lnL card vs host (fp64
     Taylor, 64 sites) and fp32 vs fp64, the substitution counts card vs
     host (equal);
 15. contrast-MEME on that alignment cut to 128 codons, ``warmup
     contrast-meme ... --permutations 1`` with the fused Nelder-Mead
     probes: seconds per stage (alternative,
     null, pairwise, permutations), the solves' items and chunks, K1
     launches; the mixture site lnL with per-item permuted set maps card vs
     host (fp64 Taylor, 64 sites), permutation p in multiples of 1/2;
 16. ``warmup meme --resample 1`` on phase 9's alignment cut to 64 codons,
     with the fused probes: the simulation's and the refits' seconds, p in
     multiples of 1/2, the card's fp64 family propagators of two sites
     against ``scipy.linalg.expm`` on three branches (1e-10).

 17. PRIME at 1000 taxa on phase 9's alignment cut to 512 codons, with
     the fused Nelder-Mead probes,
     ``warmup prime``: seconds
     per stage (load, GTR, MG94, grid, the full fit, the five nulls,
     JSON), ms per batched site evaluation, K1 launches, peak memory; the
     per-site objective card vs host (fp64 Taylor, 64 sites, 1e-9, one
     point at |lambda| = 10) and fp32 vs fp64 on every pattern (0.03); the
     JSON's 18 columns and p in [0, 1];
 18. BUSTED at full width on phase 9's alignment, ``warmup busted`` (SRV
     3 x 3, 2 starting points): seconds per stage, ms per value and
     gradient of the mixture lnL, K1 launches per evaluation (one per
     level for all three SRV classes), peak memory; the site lnL at the
     fitted point card vs host (fp64 Taylor, 64 patterns, 1e-9 relative;
     fp64 spectral, 1e-6 relative, finite and below 0, also with a
     synonymous-rate class at time 1e16), fp32 Taylor vs fp64 spectral (0.03 per pattern, 10 on the lnL), the
     folded classes equal to each class pruned alone; the --srv-hmm,
     --srv-branchsite and --multiple-hits Double+Triple objectives card vs
     host at the same point; LRT >= 0, p in [0, 1], finite evidence
     ratios, the JSON's keys; ms per value and value+gradient with the
     fp32 Taylor propagators by the per-group loop and by the batched
     per-branch route;
 19. ``warmup busted --error-sink`` on phase 9's alignment cut to 512
     codons, then ``error-filter`` on its JSON: the seconds of the
     branch-pinned site lnLs; class posteriors summing to 1, the pinned
     site lnLs re-mixed with the fitted weights equal to the site lnL
     (1e-5 relative), every masked sequence of full length;
 20. ``warmup busted-ph --branches FG`` on phase 14's alignment cut to 512
     codons, then ``clade-support`` on its JSON: seconds per test, three p
     in [0, 1], a perplexity >= 1;
 21. RELAX at full width on phase 14's alignment, ``warmup relax --test FG
     --reference REF --models All`` (the unlabelled branches the nuisance
     set: 3 groups for the alternative, one per branch, 1998, for the
     general-descriptive model): seconds per stage (GTR, MG94, general
     descriptive, alternative, null, partitioned descriptive, JSON), ms per
     value and value+gradient of the general-descriptive and alternative
     objectives, launches, host syncs and propagator calls per
     general-descriptive value, one value profiled, K1 launches, peak
     memory, the alternative's ms on both forms of the fp32 Taylor route;
     the general-descriptive site lnL card vs host (fp64 Taylor, 64
     patterns, 1e-9 relative) and fp32 vs fp64 Taylor (0.03 per pattern),
     the batched per-branch propagators against the per-group loop's calls
     on 16 branches (fp32 1e-6, fp64 1e-12, both timed) and the fp64 ones
     against ``scipy.linalg.expm`` on three branches (1e-10); LRT >= 0, p in
     [0, 1], Test omegas = Reference omegas ^ K at equal weights (1e-6), the
     JSON's fits;
 22. RELAX group mode on phase 14's alignment cut to 512 codons, ``warmup
     relax --groups FG,REF,Unlabeled --reference Unlabeled``: seconds per
     stage, K1 launches, ms on both forms of the fp32 Taylor route; df = 2,
     the two K, the group objective card vs host (fp64 Taylor, 64 patterns,
     1e-9 relative);
 23. aBSREL on ``simulated_codon_alignment(32, 1024, seed=11)``, ``warmup
     absrel --srv Yes``: seconds per stage (baseline, step-up with its fits
     and classes added, polish, branch nulls), ms per value and
     value+gradient, K1 launches, peak memory; two branches' nulls, with
     their last omega set to 4, fitted on the card under the same cap (no
     lower than the refit full model); the objective card vs host
     at mixed class counts 1-5 (fp64 Taylor, 1e-9 relative; also with
     Double+Triple per-branch bases), fp32 vs fp64 (0.03 per pattern), the
     SRV posteriors summing to 1 and rates of unit mean (1e-6), Holm-corrected
     p non-decreasing in the uncorrected p;
 24. LEISR at full width: a protein alignment of 1000 taxa x 2048 residues
     simulated under WAG along phase 4's tree (with phase 25's planted
     block), ``warmup leisr --type protein --model LG``, and phase 4's
     alignment read as 6144 nucleotides, ``warmup leisr --type nucleotide
     --model GTR``: seconds per stage (load, baseline fit, site fits, CI),
     Nelder-Mead iterations, ms per batched site evaluation, K1 launches,
     peak memory; the site lnL at r = 1 and three other rates card vs host
     (fp64, 1e-9 relative), fp32 Taylor vs fp64 per pattern (0.03), LB <=
     MLE <= UB, LogL local >= LogL global - 1e-3, r = 0 at constant sites,
     the CI of 64 sites fp32 vs fp64 (1e-3 relative, or both at the cap);
 25. FADE on the protein alignment's first 512 residues along the contrast
     tree, where its seven planted residues evolve on the FG clade under
     FADE's biased WAG generator toward K (rate 1, bias 10), ``warmup fade
     --model WAG --branches FG`` (400 grid points, 20 residues,
     Variational-Bayes): seconds per target (grid pass, posterior), grid
     chunk, K1 launches, peak memory; six grid points toward K card vs host
     (fp64, 1e-9 relative at finite entries, -inf at the same entries) and
     fp32 vs fp64 (0.03), the biased propagators at bias 50 against
     ``scipy.linalg.expm`` (fp64 1e-10, the fp32 pruning's input 1e-5),
     Prob[bias>0] in [0, 1], the planted residues' mean Prob[bias>0] toward
     K above the rest's;
 26. FitMultiModel at full width on phase 4's alignment, ``warmup fmm``:
     seconds per fit (GTR, MG94, 1H, each coarse and polish fit of 2H and
     3H), ms per GDD value and value+gradient with K1 launches per value
     (the 3 classes folded into K1's node axis), peak memory; the GDD site
     lnL at the fitted 3H point card vs host on 64 codons (fp64 Taylor 1e-9
     relative, spectral 1e-6), fp32 vs fp64 per pattern (0.03), class
     weights summing to 1 (1e-6), every lnL, LRT and evidence ratio finite,
     the JSON's keys;
 27. BGM on phase 9's alignment cut to 128 codons at 1000 taxa, ``warmup
     bgm`` at its defaults (100000 order-MCMC steps): seconds per stage (the
     GTR and MG94 fits and K8 on the card; the families and the order-MCMC
     on the host), K1 launches, peak memory; the substitution map from the
     card's fp64 joint states equal to the one from the host's fp64 K8 on
     the same propagators, the cells fp32 K8 changes, the table's
     P[1->2], P[2->1] in [0, 1] with sum at most 1 (+1e-12);
 28. GARD through ``gard.run`` under ``warmup`` (L-BFGS capped at 3
     iterations) on 24 taxa x 1200 sites, two halves simulated under GTR
     along two different trees, capped at 24 single-breakpoint candidates,
     population 8, 3 stagnant generations, 3 breakpoints: seconds of TN93
     and NJ on the host, and per candidate fit (K1 at 4 states) its
     seconds, evaluations and K1 launches; a breakpoint within 30 sites of
     the planted one with c-AIC below the baseline's; the run resumed from
     its checkpoint fits only the baseline and ends alike; the baseline and
     the best model fitted to convergence in fp32, the best below the
     baseline;
 29. the rest of the engine at full width, through its library entry
     points: (a) the Binary model on 1000 taxa x 8192 presence/absence
     characters simulated along phase 4's tree, fitted capped in fp32 (K1
     at 2 states), lnL card fp64 vs host fp64 (1e-9 relative) and fp32 vs
     fp64 per pattern (0.03); (b) GTR on phase 4's alignment read as 6144
     nucleotides, fitted capped with theta_AC := R theta_AT and with a
     molecular clock (1 height + 998 fractions): each constraint exact, the
     root-to-tip paths equal (1e-9 relative), card vs host fp64 lnL (1e-9
     relative); (c) MG94xREV (F1x4) and MG94xREVLocal (CF3x4, 3996
     per-branch rates) on phase 4's alignment, fitted capped: ms per value
     and value+gradient, K1 per value, the propagators' ms (1998 per-branch
     generators: fp32 Taylor, fp64 spectral), fp32 vs fp64 per pattern
     (0.03); (d) the covariance of the five thetas and omega at the
     MG94xREV fit in fp64 (an autograd Hessian through K1's
     twice-differentiable wrapper): symmetric (1e-8), its inverse against
     central differences of the gradient (1e-4 of the largest entry), and
     the profile CI of omega (LB <= MLE <= UB, its loglik evaluations
     counted); (e) the marginal posteriors of all 999 internal nodes x 2048
     patterns in fp64: rows summing to 1 (1e-9), card vs host on 64
     patterns (1e-9); (f) the dense per-site route against the Taylor one
     on 64 sites (1e-9), expm and transition_matrix against scipy on 64
     generators (1e-10), the discretized gamma and its alpha gradient card
     vs host (1e-10), the native aligners against their Python mirrors and
     the native TN93 against NumPy's on phase 28's input (1e-12);
 30. the device mesh (``parallel/mesh.py``) over every visible card when
     there are two or more, else over four shards of the one card (a line
     says which): (a) MG94xREV at bench.py's point in fp32 and fp64,
     sharded against unsharded (lnL 1e-12 relative, the site vectors at
     their true width, the gradient 1e-6 / 1e-10 relative in norm), ms per
     value and value+gradient, K1 launches per value on each device, peak
     memory per device; (b) a mixed mesh (the card, the host) on 48 taxa x
     128 codons in fp64 against the card alone; (c) ``fel.run`` capped on
     that input over the mesh (two shards of a single card) with the fused
     Nelder-Mead probes, its site
     table against the unsharded per-site stage on the run's own global fit
     (1e-9), and over the mixed mesh in fp64 on 24 codons (1e-6: the
     host's and the card's eigensolvers round apart); the automatic
     mesh keeps (a)'s gene on one card; (d) the BUSTED
     mixture at 512 planted codons, value and gradient as in (a); (e) every
     other per-site solve, each block run from a host thread of its own:
     FUBAR's grid pass and posterior, a FADE target, MEME's stages 1-3 and
     EBFs, contrast-FEL, contrast-MEME's fits and a permutation, PRIME and
     LEISR (GTR) on 48 taxa x 16 codons (FADE on 16 random residues),
     sharded (over every card, or two shards of the one card) against
     unsharded at one capped fit: bit-equal on a mesh of cards, a block on
     every device, K1 on every card for the grid passes; the grid pass and
     MEME's stages on 4 sites over (card, host) in fp64 (1e-6); on distinct
     cards FEL's per-site stage of (c) and MEME's stages timed both ways
     and profiled per card.

``--precision-check`` runs phases 1-3 and then, in place of phases 4-30,
FEL's per-site stage on phase 8's input at one capped global fit, run to
convergence in fp32 and in fp64: the same p <= 0.1 set, and alpha and beta
within the stated tolerance at all but 5% of the sites.  ``--busted-check``
runs phases 1-3 and then BUSTED with its fits run to convergence, in fp32
and in fp64, on phase 18's input cut to 1024 codons, on bench.py's
alignment cut to 256 codons and on an episodic positive control (128
codons, omega 20 on a random 5% of the branches in each block of 64
codons): each fit's lnL, iterations, restarts, seconds and why it stopped;
every lnL finite and below 0, the unconstrained no lower than the
constrained; on the planted input in fp64, the fit at or above every
point of a scan near the planted truth; the two precisions within 10 lnL
and calling alike; p <= 0.05 on the control.  Every input runs; the phase
fails after the last if one failed.  ``--relax-check`` runs phases 1-3 and
then RELAX ``--models Minimal`` with every fit run to convergence, in fp32
and fp64, on phase 14's alignment cut to 512 codons (alternative no lower
than the null, the precisions within 10 lnL and calling alike at 0.05; the
fp64 general-descriptive value at the alternative's MLE on the spectral
route timed, K6 on 5994 families, and held to the per-branch Taylor route
at 1e-9 relative), and
aBSREL uncapped in fp32 on the episodic control along 32 taxa, 512 codons
(the full model no lower than any branch null); each fit's counters are
reported.  ``--mesh`` runs phases 1-3 and then phase 30 alone (on a host
of four cards); ``--mesh-width`` runs phases 1-3 and then (f): FEL's
per-site stage at phase 4's width and MEME's stages at phase 11's, on one
card against every card of the host, timed and held bit for bit.

K1's ``launches`` on the kernels line sum the phases that drive a method
(4, 7-30, or the precision, BUSTED, RELAX or mesh check), each counted from 0
around its run.  It
imports nothing of ``jax`` or ``hyphy_tpu``.  Its last three lines are
the card's name and power limit, one JSON object describing every kernel,
and ``{"ok": true, "device": {...}}``; a longer record goes to
``chiprun_out/chip_smoke.json``.  Without CUDA it exits with 1 and prints
no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

# lnL of the JAX package on the CPU in fp64 at bench.py's parameter point on
# its 1000-taxon x 2048-codon workload (BENCH_r05.json, "lnl_fp64").
ANCHOR_FP64 = -4889039.92475695
# The fp64 codon propagators come from an eigendecomposition whose absolute
# round-off (~1e-15) is a large relative error in the tiny P entries of
# multi-step changes across the workload's short branches (201 of 1998
# branches are below 0.005).  The anchor is therefore only reproducible to
# O(1) lnL: the HyPhy binary gives -4889041.17 (1.25 away), and phase 5
# prints the same point with Taylor-route fp64 propagators, which keep those
# entries accurate and are held to the HyPhy binary's value.  The card's
# spectral fp64 value is held to the anchor within this bound (it lies 0.034
# away); the kernel itself is held tightly by the identical-input comparison.
ANCHOR_BOUND = 0.5
HYPHY_LNL = -4889041.174467024   # bench_baseline.json "reference_lnL"
HYPHY_BOUND = 1e-3         # |Taylor-route fp64 lnL - HYPHY_LNL| on the card
FP32_BOUND = 10.0          # |lnL fp32 - lnL fp64| on the card

# NVIDIA H100 SXM data sheet, dense, outside the tensor cores
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
N_TAXA, N_CODONS, SEED = 1000, 2048, 11
DEVICE = "cuda"
# (5,2,700,61): the JAX package's kernel test; (500,2,2048,61): wider than
# the bench tree's widest level (320 nodes), the row the kernels line
# reports; (3,3,1000,61): K=3 with a ragged last pattern tile;
# (320,2,6144,4): the GTR fit's widest level (6144 nucleotide patterns);
# (320,2,2048,20): the protein evaluation's widest level (LEISR's 2048
# residues; 20 of K1's 32 state rows filled in fp32 and fp64 alike);
# (320,2,8192,2): the Binary fit's widest level (phase 29's BINARY_CHARS
# presence/absence characters keep ~8192 patterns; 2 of 32 state rows)
BINARY_CHARS, BINARY_FREQS = 8192, (0.6, 0.4)
KERNEL_SHAPES = [(5, 2, 700, 61), (500, 2, 2048, 61), (3, 3, 1000, 61),
                 (320, 2, 6144, 4), (320, 2, 2048, 20), (320, 2, BINARY_CHARS, 2)]
# shapes the kernel's tiling is exposed to: odd P (misaligned tile starts),
# K=3 ragged, the amino-acid width (8 state groups), full lanes on one node,
# a polytomy at S=4
EDGE_SHAPES = [(7, 2, 2047, 61), (4, 3, 1001, 61), (2, 2, 333, 20),
               (1, 2, 2048, 64), (9, 5, 130, 4)]
# Tree.levels() widths of random_tree_newick(N_TAXA, seed=SEED), all K=2;
# one evaluation launches K1 once per level (phase 5 checks the count)
LEVEL_WIDTHS = [320, 200, 133, 90, 61, 49, 36, 27, 18, 13, 12, 8, 6, 5, 4, 3,
                3, 3, 3, 2, 1, 1, 1]
# (patterns, states) of the codon (MG94), nucleotide (GTR), protein
# (LEISR's baseline) and binary (phase 29) evaluations
LEVEL_PATTERNS = [(N_CODONS, 61), (3 * N_CODONS, 4), (N_CODONS, 20), (BINARY_CHARS, 2)]
REL_BOUND = {"float32": 1e-5, "float64": 1e-12}
# phase 6: rows of FEL's SRV start grid, (alpha, beta) = (0.01, 0.1),
# (1, 1), (10, 50); sites held card against host; bounds on the per-site lnL
SITE_GRID_ROWS = [0, 3, 10]
SITE_PARITY_N = 64
SITE_HOST_BOUND = 1e-9     # |d site lnL|, fp64, card vs host on identical inputs
# ... except the spectral route at (0.01, 0.1): there the branches' effective
# lengths are short, their multi-step P entries are sums of eigenvector
# terms that cancel to ~1e-14 (ROADMAP.md 3.5), and the card's and the
# host's summation orders alone give site lnLs up to 3.4e-7 apart at the capped
# fit's binary tree and 3.6e-4 apart at the uncapped fit's ~1000-child root
# (H100); the Taylor route holds 1e-9 at the same points
SITE_SPECTRAL_BOUNDS = {(0.01, 0.1): 1e-3}
SITE_FP32_BOUND = 0.03     # |d site lnL|, fp32 vs fp64 Taylor (7.3e-3 on the H100)
# the profiler holds one event per launch: the looped fp64 eigh launches
# ~150 kernels per matrix, so the spectral route and eigh are profiled on
# this many sites (events and the host clock time all of them)
SITE_PROFILE_N = 64
# phase 7: bench.py's alignment as 2 CHARSETs of 1024 codons (4 of 512 until
# phases 27-28 needed the room: each partition adds its own launch-bound
# per-site fits); per-site (alpha, beta, delta, psi) points of the
# card-vs-host multi-hit check
N_PARTS, PART_CODONS = 2, 1024
MH_SITE_POINTS = [(1.0, 1.0, 0.05, 0.05), (0.01, 0.1, 1.0, 1.0), (10.0, 50.0, 10.0, 5.0)]
# phase 8: taxa and codons of the CI / bootstrap run, and bootstrap
# replicates: the CI's evaluations are a fixed number of bisection and
# Nelder-Mead steps whose launches follow the tree's levels, so the run is
# cut in taxa (random_tree_newick(CI_TAXA, SEED)) for the 900 s budget: 48
# taxa (9 levels) since phase 29 (128 taxa, 13 levels, until then)
CI_TAXA, CI_CODONS, N_RESAMPLE = 48, 128, 10
# the fused Nelder-Mead probes: sites (512 cut for phases 27-28), and
# iterations timed
FUSED_SITES, FUSED_ITERATIONS = [128], 6
# phases 9-11: an alignment simulated along random_tree_newick(N_TAXA, SEED)
# with omega = PLANTED_OMEGA at these codons (0.3 elsewhere)
PLANTED_SITES, PLANTED_OMEGA = [37, 101, 190, 263, 333, 402, 475, 1100, 1700], 5.0
# phase 9: SLAC's ancestral samples; patterns held card vs host; root lnL bound
# (samples cut from 10 for phases 27-28's room in the chip budget)
SLAC_SAMPLES, SLAC_HOST_PATTERNS, SLAC_LNL_REL_BOUND = 5, 512, 1e-9
# phase 11: MEME's codons (the EBF's items grow with codons x tested
# branches: ~1.02 M at 512; cut to 128 for phases 21-23's room in the
# chip budget, to 64 for phases 24-26's); sites (64 until phases 27-28)
# and forced items per chunk of the split
MEME_CODONS, SPLIT_SITES, SPLIT_CHUNK = 64, 16, 997
# phase 12: FUBAR's grid (points per axis); grid points held fp32 vs fp64
# (alpha > 0 and beta > 0: where alpha or beta is 0 the fp64 spectral route
# gives round-off for unreachable codons, ROADMAP 3.5) and folded vs one by
# one; the bounds per pattern
GRID_POINTS, GRID_FP32_POINTS, GRID_FOLD_POINTS = 20, [66, 128, 211, 295], [150, 275]
GRID_FP32_BOUND = 0.03      # |d site lnL|, fp32 Taylor vs fp64 spectral, per pattern
GRID_FOLD_REL_BOUND = 1e-5  # folded grid form vs the one-set form, fp32, relative
# phase 13: B-STILL's codons (cut for the chip budget)
BSTILL_CODONS = 256
FORCED_PATTERNS = 64   # B-STILL's pass 2 again with the chunk forced past K1's node limit
# phase 14: the contrast alignment: two disjoint clades of ~250 leaves of
# random_tree_newick(N_TAXA, SEED) labelled FG and REF (the rest background,
# G = 3), omega = PLANTED_OMEGA on the FG branches only at PLANTED_SITES
CONTRAST_CLADES, CONTRAST_LABELS = [250, 250], ["FG", "REF"]
# phase 14: contrast-FEL's codons (cut for the chip budget; the per-site
# route with G = 3 stays at 1000 taxa)
CFEL_CODONS = 512
# phase 15: contrast-MEME's codons and permutations (cut from 256 and 3 for
# phases 27-28's room in the chip budget)
CMEME_CODONS, CMEME_PERMUTATIONS = 128, 1
# phase 16: MEME --resample's codons and replicates (cut from 3 for phases
# 27-28); sites and branches of the propagator check against scipy
RESAMPLE_CODONS, MEME_RESAMPLE = 64, 1
RESAMPLE_CHECK_SITES, RESAMPLE_CHECK_BRANCHES = 2, 3
RESAMPLE_EXPM_BOUND = 1e-10
# phase 17: PRIME's codons (cut for the chip budget); its per-site
# objective card vs host (fp64 Taylor) at these
# (alpha, beta, lambda_0, other lambdas) points, one with |lambda| = 10
PRIME_POINTS = [(1.0, 0.5, 0.1, 0.1), (0.3, 2.0, -1.0, 0.5), (1.0, 1.0, -10.0, 0.1)]
PRIME_CODONS = 512
# phase 18: BUSTED's mixture site lnL card vs host (fp64 Taylor, relative),
# fp32 Taylor vs fp64 spectral per pattern and on the whole lnL
BUSTED_HOST_REL_BOUND, BUSTED_FP32_SITE_BOUND, BUSTED_FP32_TOTAL_BOUND = 1e-9, 0.03, 10.0
# ... and the fp64 spectral site lnL card vs host (relative), finite and
# below 0, at the fitted point and at a synonymous-rate class at time 1e16:
# the two eigensolvers' round-off meets the cancelling eigenvector sums of
# short branches (SITE_SPECTRAL_BOUNDS, ROADMAP 3.5), so the bound is the
# size of those differences, far below a fault of the route (lnL +8.4e7)
BUSTED_SPECTRAL_HOST_REL_BOUND = 1e-6
# phase 19: BUSTED-E's codons (the JSON carries [tested branches, K+1,
# sites] posteriors), the class posteriors' sum and the re-mixing bound
ERROR_SINK_CODONS, POSTERIOR_SUM_BOUND, REMIX_REL_BOUND = 512, 1e-6, 1e-5
# phase 20: BUSTED-PH's codons on the contrast alignment
BUSTEDPH_CODONS = 512
# phase 21: RELAX classic at full width on the contrast alignment (FG
# tested, REF the reference, the unlabelled branches the nuisance set);
# branches of the propagators held against scipy; the batched per-branch
# propagators against the per-group route's per-family calls on
# RELAX_LOOP_BRANCHES branches (absolute, per precision; the loop takes
# ~4 ms per family on an H100, ~20 s per precision over all 1998 groups); Test
# omegas against Reference omegas ^ K, and their weights (relative)
RELAX_EXPM_BRANCHES, RELAX_LOOP_BRANCHES = 3, 16
RELAX_LOOP_BOUND = {"float32": 1e-6, "float64": 1e-12}
RELAX_POWER_BOUND = 1e-6
# phase 22: RELAX group mode's codons
RELAX_GROUP_CODONS = 512
# phase 23: aBSREL's taxa and codons: the step-up fits every branch at
# least once, one capped fit each, so 1000 taxa (1998 branches) would not
# fit the run; codons cut to 1024 and taxa to 48 (from 64), then to 32 for
# phase 29, for the 900 s budget
ABSREL_TAXA, ABSREL_CODONS = 32, 1024
# --relax-check: RELAX --models Minimal uncapped on the contrast alignment
# cut to RELAX_CHECK_CODONS codons in fp32 and fp64; aBSREL uncapped in fp32
# on the episodic alignment (below) along ABSREL_CHECK_TAXA taxa, of
# ABSREL_CHECK_CODONS codons, where branches carry omega > 1 and get nulls
RELAX_CHECK_CODONS, ABSREL_CHECK_TAXA, ABSREL_CHECK_CODONS = 512, 32, 512
# --relax-check: the fp64 general-descriptive value (one group per branch)
# on the spectral route against the per-branch Taylor route (relative)
RELAX_SPECTRAL_REL_BOUND = 1e-9
# phases 24-25: a protein alignment of N_TAXA x N_CODONS residues simulated
# under WAG along random_tree_newick(N_TAXA, SEED), with FADE's biased
# generator (toward FADE_TARGET at FADE_RATE, FADE_BIAS) on the contrast
# tree's FG clade at the planted positions below FADE_SITES, FADE's input
FADE_SITES, FADE_TARGET, FADE_RATE, FADE_BIAS = 512, "K", 1.0, 10.0
# phase 24: LEISR's site lnL card vs host (fp64 spectral, relative) at these
# rates; the profile CI of LEISR_CI_SITES variable patterns, fp32 against
# fp64 (relative, or both at the same cap)
LEISR_RATES, LEISR_HOST_REL_BOUND = [1.0, 0.1, 3.0, 1e-3], 1e-9
LEISR_CI_SITES, LEISR_CI_REL_BOUND = 64, 1e-3
LEISR_LOCAL_SLACK = 1e-3    # LogL local >= LogL global - this (fp32)
# phase 25: grid points held card vs host (fp64, relative at finite entries)
# and fp32 vs fp64 (per pattern): rate 0; rate 1/15 at bias 0 and 50; rate 1
# at bias 1 and 50; rate 50 at bias 50; the biased propagators at bias 50
# against scipy (fp64, and the fp32 pruning's input) on FADE_EXPM_BRANCHES
FADE_HOST_POINTS, FADE_HOST_REL_BOUND = [0, 1, 19, 273, 279, 399], 1e-9
FADE_EXPM_BOUND = {"float64": 1e-10, "float32": 1e-5}
FADE_EXPM_BRANCHES = 3
# phase 26: patterns of the GDD site lnL card vs host (fp64 Taylor,
# relative; the spectral route at BUSTED's bound, the eigensolvers parting
# at short branches, ROADMAP 3.5); the class weights' sum
FMM_HOST_SITES, FMM_HOST_REL_BOUND, FMM_SPECTRAL_HOST_REL_BOUND = 64, 1e-9, 1e-6
FMM_WEIGHT_SUM_BOUND = 1e-6
FMM_JSON_KEYS = ["Evidence Ratios", "Site Log Likelihood", "analysis", "data partitions",
                 "fits", "input", "test results", "tested", "timers"]
# phase 27: BGM's codons of the planted alignment (BGM runs on single genes;
# its host families grow with the square of the sites that carry a
# substitution), and the slack on P[1->2] + P[2->1] <= 1 (one order allows
# one direction only)
BGM_CODONS, BGM_PROB_SLACK = 128, 1e-12
# phase 28: GARD's input, two halves of GARD_HALF sites simulated under GTR
# (GARD_RATES: AC, AG, AT, CG, CT, GT; GARD_FREQS: A, C, G, T) along
# random_tree_newick(GARD_TAXA, seed) for each seed of GARD_TREE_SEEDS; the
# caps of the search (at most GARD_CANDIDATES single-breakpoint candidates,
# through the candidate stride); the best model's breakpoint within
# GARD_BREAKPOINT_SLACK sites of the planted one; 24 taxa and 24 candidates,
# cut from 32 and 32 (the 32-taxon run took 90.5 s of a 45 s target, the
# 24-taxon one 72.1 s, PERF.md); at 24 candidates both neighbours of the
# planted site lie within the slack (23 and 26 sites), at 16 only one does
GARD_TAXA, GARD_HALF, GARD_TREE_SEEDS = 24, 600, (SEED, SEED + 1)
GARD_RATES, GARD_FREQS = (1.0, 4.0, 1.0, 1.0, 4.0, 1.0), (0.3, 0.2, 0.25, 0.25)
GARD_CANDIDATES, GARD_POPULATION, GARD_STAGNANT, GARD_MAX_BREAKPOINTS = 24, 8, 3, 3
GARD_BREAKPOINT_SLACK = 30
# phase 29 (the rest of the engine): (a) a presence/absence matrix of
# BINARY_CHARS characters simulated under Binary(BINARY_FREQS) along
# random_tree_newick(N_TAXA, SEED) (pangenome gene-presence matrices of about a
# thousand genomes by some thousands of gene families), its fit capped; (b)
# bench.py's alignment read as nucleotides under GTR with a Proportional and a
# MolecularClock constraint; (c) MG94xREV (F1x4) and MG94xREVLocal (CF3x4) on
# bench.py's workload; (d) the covariance of ENGINE_COV_KEYS and the profile
# CI of omega at the MG94xREV fit in fp64; (e) the marginal posteriors of
# every internal node in fp64; (f) the small checks.  Bounds: card fp64 lnL
# against the host's (relative); fp32 against fp64 per pattern; constraint
# paths (relative); the Hessian's symmetry and its central differences
# (relative to its largest entry, steps ENGINE_FD_STEP relative); posterior
# rows; the dense per-site route against the Taylor one; expm against scipy
ENGINE_HOST_REL_BOUND, ENGINE_FP32_SITE_BOUND, CLOCK_PATH_REL_BOUND = 1e-9, 0.03, 1e-9
ENGINE_COV_KEYS = ["theta_AC", "theta_AT", "theta_CG", "theta_CT", "theta_GT", "omega"]
HESSIAN_SYM_BOUND, HESSIAN_FD_BOUND, ENGINE_FD_STEP = 1e-8, 1e-4, 1e-4
POSTERIOR_ROW_BOUND, MARGINAL_HOST_PATTERNS, MARGINAL_HOST_BOUND = 1e-9, 64, 1e-9
DENSE_SITES, DENSE_BOUND, EXPM_GENERATORS, EXPM_BOUND = 64, 1e-9, 64, 1e-10
GAMMA_ALPHAS, GAMMA_BOUND, TN93_BOUND = (0.3, 1.0, 5.0), 1e-10, 1e-12
# --busted-check: BUSTED uncapped in fp32 and fp64 on three inputs, each
# fit's lnL finite and below 0 and the unconstrained lnL no lower than the
# constrained one less ALT_NULL_SLACK (the refit from the constrained MLE
# starts omega_k 1e-12 off its bound):
#   * phase 18's input (the planted alignment) cut to BUSTED_CHECK_CODONS
#     codons (at 2048 it and the control took over 1100 s of command); in
#     fp64 the unconstrained lnL also lies at or above every point of a scan
#     that puts omega_3 at PLANTED_SCAN_OMEGAS with weights PLANTED_SCAN_SHARES
#     times the planted codons' share, at the fitted mean omega;
#   * bench.py's alignment cut to BENCH_CHECK_CODONS codons (random codons on
#     a tree they were not drawn on: the fits reach the box's corners, where
#     an fp64 fit at 512 codons returned lnL +8.4e7 before the zero modes
#     were settled, ROADMAP 3.15; 256 codons keep the check's time);
#   * an episodic positive control of BUSTED_POSITIVE_CODONS codons (omega
#     EPISODIC_OMEGA on a fresh EPISODIC_SHARE of the branches in each block
#     of EPISODIC_BLOCK codons): p <= 0.05 in both precisions
BUSTED_CHECK_CODONS, BENCH_CHECK_CODONS, BUSTED_POSITIVE_CODONS = 1024, 256, 128
ALT_NULL_SLACK = 1e-6
PLANTED_SCAN_OMEGAS, PLANTED_SCAN_SHARES = (2.0, 5.0, 10.0, 20.0), (0.25, 0.5, 1.0, 2.0, 4.0)
EPISODIC_OMEGA, EPISODIC_SHARE, EPISODIC_BLOCK = 20.0, 0.05, 64
# --precision-check: FEL's per-site stage on phase 8's input, uncapped, in
# fp32 and in fp64 at one global fit: the same p <= 0.1 set, and alpha and
# beta within PRECISION_RATE_ATOL + PRECISION_RATE_RTOL * |fp64 value| at
# all but PRECISION_OUTLIER_SHARE of the sites (rates along which a site's
# lnL is flat, at 0 or past the data's information, stop where each
# precision's simplex ends)
PRECISION_RATE_ATOL, PRECISION_RATE_RTOL, PRECISION_OUTLIER_SHARE = 0.01, 0.05, 0.05


# phase 30, the device mesh: every visible card when there are two or more,
# else MESH_SHARDS shards of the one card; (a) MG94xREV at bench.py's point in
# fp32 and fp64, sharded against unsharded: lnL within MESH_LNL_REL
# (relative), the site vectors equal in width and within MESH_SITE_REL
# (relative to each pattern's lnL), the gradient reported; at a
# well-conditioned point (distinct thetas, branches of at least 0.05) the site
# vectors again and the gradient within MESH_GRAD_REL in norm (relative), in
# fp64 over the branch lengths (the other keys pass through eigh's backward,
# which amplifies summation order; reported); (b) a mixed mesh (the card, the
# host) at MESH_SMALL_TAXA x MESH_SMALL_CODONS in fp64 against the card
# alone, as the conditioned point of (a); (c)
# `fel.run` capped on that input over the mesh, its site table against the
# unsharded per-site stage on the run's own global fit within MESH_TABLE_ATOL,
# and again over the mixed mesh in fp64 on its first MESH_MIXED_CODONS codons
# within MESH_MIXED_TABLE_ATOL (the host's and the card's eigh differ in their
# last bits, which the capped Nelder-Mead carries to ~1e-9 in the LRT and
# p-value columns; a block on the wrong device or rows out of order would
# be off by far more, or fail);
# (d) the BUSTED mixture (3 omega x 3 synonymous-rate classes) at
# MESH_BUSTED_CODONS planted codons, value and gradient as at (a)'s
# conditioned point; (e) every other per-site solve that the JAX package
# shards: FUBAR's grid pass and its posterior, a FADE target's grid pass,
# MEME's stages 1-3 and its EBFs, contrast-FEL, contrast-MEME's fits and one
# permutation of as many sites as the mesh has blocks (one item a block),
# PRIME, LEISR (GTR; the protein models take the same solve, held on the
# CPU); on the first MESH_SITE_CODONS codons of (b)'s input (the contrast
# methods on its tree with two clades of about MESH_SITE_CLADES leaves
# labelled; FADE on as many random residues), at
# one capped global fit, grids of MESH_SITE_GRID points a side, the fused
# probes and the Nelder-Mead capped at MESH_SITE_NM iterations (the blocks
# give the one batch's results after any number): each sharded against
# unsharded, every output equal bit for bit (infinities in place) on a mesh
# of cards, every device of the mesh given a block, K1 launched on every
# card by the grid passes; over the (card, host) mesh in fp64 the grid pass
# and MEME's stages on MESH_MIXED_SITES sites within MESH_MIXED_SITE_REL
# (relative above 1, absolute below; the eigensolvers round apart; an EBF
# is not held there: near a posterior of 1 it is the quotient of a
# cancellation, and one ulp of a forced lnL moves it by orders).  On
# one card (c) and (e) run over MESH_SITE_SHARDS shards of it, not
# MESH_SHARDS: with one host thread per block, four blocks of a
# Nelder-Mead stage on one card took 12-14x the unsharded time (PERF.md),
# and the default script has no room for that.  On distinct cards
# FEL's per-site stage of (c) and MEME's three stages are also profiled
# per card both ways
MESH_SHARDS, MESH_REPS = 4, 2
MESH_LNL_REL, MESH_SITE_REL = 1e-12, {"float32": 1e-6, "float64": 1e-12}
MESH_GRAD_REL = {"float32": 1e-6, "float64": 1e-10}
MESH_SMALL_TAXA, MESH_SMALL_CODONS, MESH_TABLE_ATOL = 48, 128, 1e-9
MESH_MIXED_CODONS, MESH_MIXED_TABLE_ATOL = 24, 1e-6
MESH_BUSTED_CODONS = 512
MESH_SITE_CODONS, MESH_SITE_NM, MESH_SITE_CLADES = 16, 1, (12, 10)
MESH_SITE_GRID, MESH_SITE_SHARDS = 10, 2
MESH_MIXED_SITES, MESH_MIXED_SITE_REL = 4, 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def gpu_time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after a warm-up.
    A sleep kernel queued first keeps the device busy while the host queues
    the launches, so that a small kernel is timed back to back and not at the
    host's launch rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once_s = time.perf_counter() - t0      # host and device time of one call
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * reps * once_s * 2e9))   # cycles, at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(torch, fn, reps: int) -> list:
    """Host-clock times of ``fn`` (each ended by a synchronize)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def profile_ms(torch, fn, path: str) -> dict:
    """One run of ``fn`` under torch.profiler: wall time, summed kernel time,
    the device's idle share, the kernels that took longest, and the device
    time of each K1 launch in launch order; the full table goes to
    ``path``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernel rows only: an operator's row repeats the time of its kernels
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    k1 = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                 and "level_products_kernel" in e.name), key=lambda e: e.time_range.start)
    with open(path, "w") as fh:
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
    return {"wall_ms": wall, "device_ms": device,
            "idle_share": 1.0 - device / wall if wall > 0 else None,
            "launches": sum(e.count for e in kernels),
            "top": [[e.key[:60], dev_us(e) / 1e3, e.count] for e in top],
            "k1_launch_ms": [dev_us(e) / 1e3 for e in k1]}


def phase_card(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi}")
    log(f"[card] torch: {name}, devices {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    return {"nvidia_smi": smi, "name": name, "count": torch.cuda.device_count()}


def phase_build() -> dict:
    from hyphy_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_sources()        # nvcc for csrc/*.cu and g++ for native/*.cpp, at once
    seconds = time.perf_counter() - t0
    log(f"[build] {', '.join(cuda_build.SOURCES)} (nvcc), "
        f"{', '.join(cuda_build.HOST_SOURCES)} (g++): {seconds:.2f} s")
    return {"seconds": seconds}


def _level_bound(shape, dtype_name):
    w, k, p, s = shape
    size = 4 if dtype_name == "float32" else 8
    nbytes = (w * k * p * s + w * k * s * s + w * p * s) * size
    flops = 2 * w * k * p * s * s + w * (k - 1) * p * s
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _hold_level(torch, shape, dtype, gen, reps: int) -> dict:
    """K1 at one shape: against its plain version, then kernel, plain and
    library times and the bound."""
    from hyphy_tpu_torch.ops.level_products import (
        level_products,
        level_products_reference,
    )

    w, k, p, s = shape
    name = str(dtype).split(".")[1]
    cc = torch.rand(shape, generator=gen, device=DEVICE, dtype=dtype) * 0.9 + 0.1
    cp = torch.rand((w, k, s, s), generator=gen, device=DEVICE, dtype=dtype) * 0.2
    out = level_products(cc, cp)
    ref = level_products_reference(cc, cp)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / ref.abs()).max())
    # kernel and plain version may round alike; the fp64 product of the
    # same inputs shows the kernel's own fp32 error
    vs64 = float(((out.double() - level_products_reference(cc.double(), cp.double()))
                  .abs() / ref.double().abs()).max()) if dtype == torch.float32 else 0.0
    ms = gpu_time_ms(torch, lambda: level_products(cc, cp), reps)
    plain_ms = gpu_time_ms(torch, lambda: level_products_reference(cc, cp), reps)
    # yardstick the port never calls: torch.einsum + prod (two calls)
    library_ms = gpu_time_ms(
        torch, lambda: torch.einsum("wkij,wkpj->wkpi", cp, cc).prod(dim=1), reps)
    bound_ms, bound_by = _level_bound(shape, name)
    check(math.isfinite(max_rel) and max_rel <= REL_BOUND[name],
          f"level_products {shape} {name} disagrees with its plain version "
          f"(max rel {max_rel:.3e})")
    return dict(shape=list(shape), dtype=name, max_abs_err=max_abs,
                max_rel_err=max_rel, max_rel_err_vs_fp64=vs64,
                rel_bound=REL_BOUND[name], ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_kernels(torch) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for shape in KERNEL_SHAPES + EDGE_SHAPES:
        w, k, p, s = shape
        for dtype in (torch.float32, torch.float64):
            row = _hold_level(torch, shape, dtype, gen, 20 if w * p > 10000 else 200)
            rows.append(row)
            log(f"[kernel] level_products {shape} {row['dtype']}: max abs "
                f"{row['max_abs_err']:.3e} max rel {row['max_rel_err']:.3e} (bound "
                f"{row['rel_bound']:.0e}), vs fp64 {row['max_rel_err_vs_fp64']:.3e}; "
                f"kernel_ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
                f"library_ms {row['library_ms']:.4f} (torch.einsum + prod, two "
                f"calls) bound_ms {row['bound_ms']:.4f} ({row['bound_by']})")
            torch.cuda.empty_cache()
    # one evaluation's K1 work: every level of the tree at its real width
    evals = []
    for p, s in LEVEL_PATTERNS:
        for dtype in (torch.float32, torch.float64):
            levels = [_hold_level(torch, (w, 2, p, s), dtype, gen, 20 if w * p > 10000 else 100)
                      for w in LEVEL_WIDTHS]
            total = {key: sum(r[key] for r in levels)
                     for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
            evals.append(dict(patterns=p, states=s, dtype=levels[0]["dtype"],
                              levels=len(levels), **total,
                              max_rel_err=max(r["max_rel_err"] for r in levels),
                              per_level_ms=[r["ms"] for r in levels]))
            log(f"[kernel] level_products per evaluation, {len(levels)} levels at "
                f"P={p} S={s} {levels[0]['dtype']}: kernel_ms {total['ms']:.4f} "
                f"plain_ms {total['plain_ms']:.4f} library_ms {total['library_ms']:.4f} "
                f"bound_ms {total['bound_ms']:.4f}; per level "
                f"{[round(r['ms'], 4) for r in levels]}")
            torch.cuda.empty_cache()
    return {"shapes": rows, "evaluation": evals}


def _write_inputs(tmp: str):
    from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment

    aln = synthetic_codon_alignment(N_TAXA, N_CODONS, seed=SEED)
    newick = random_tree_newick(N_TAXA, seed=SEED)
    fasta = os.path.join(tmp, "bench.fasta")
    with open(fasta, "w") as fh:
        fh.write("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    tree_path = os.path.join(tmp, "bench.nwk")
    with open(tree_path, "w") as fh:
        fh.write(newick)
    return aln, newick, fasta, tree_path


def _fits_from_log(path: str) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


class _StageClock:
    """Phase 4's instruments, kept out of the package: wraps the port's
    stage functions (load, GTR, MG94, grid starts, the two Nelder-Mead
    fits) and the per-site objective they are handed, records when each
    stage ends (after a synchronize) and how long each batched objective
    evaluation took, and keeps the MG94 stage's data and fit for phase 6.
    ``restore`` puts the package's functions back."""

    def __init__(self, torch):
        from hyphy_tpu_torch.methods import common, fel

        self.torch = torch
        self.ends = {}                  # stage -> perf_counter at its end
        self.evals = {"grid": [], "alt_nm": [], "null_nm": []}   # ms each
        self.n_params = {}
        self.mg94_args = self.mg94 = None
        self._saved = []
        for module, name, stage in (
            (common, "load_codon_data_multi", "load"),
            (common, "fit_gtr_multi", "gtr"),
            (common, "fit_partitioned_mg94_multi", "mg94"),
            (fel, "grid_best_starts", "grid"),
            (fel, "vmapped_nelder_mead", None),
        ):
            original = getattr(module, name)
            self._saved.append((module, name, original))
            setattr(module, name, self._wrap(original, stage))

    def _counted(self, bucket, objective):
        def wrapped(idx, params):
            t0 = time.perf_counter()
            out = objective(idx, params)
            self.torch.cuda.synchronize()
            self.evals[bucket].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    def _wrap(self, fn, stage):
        def wrapped(*args, **kwargs):
            name = stage or ("alt_nm" if "alt_nm" not in self.ends else "null_nm")
            if name in self.evals:
                args = (self._counted(name, args[0]),) + args[1:]
            if name.endswith("_nm"):
                self.n_params[name] = len(args[1])
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.ends[name] = time.perf_counter()
            if name == "mg94":
                self.mg94_args, self.mg94 = args, out
            return out
        return wrapped

    def restore(self):
        for module, name, original in self._saved:
            setattr(module, name, original)


@contextlib.contextmanager
def _recorded_solves(solves: list):
    """Every block of a per-site solve (``batched.chunked_site_solve``, which
    ``parallel/mesh.py::sharded_site_solve`` runs for each block of a mesh,
    from a thread of its own) appended to ``solves`` while the context
    lasts: its items, bytes per item and device, and, as its solver is
    called, the chunk it takes (its largest call) and its calls."""
    from hyphy_tpu_torch.optimize import batched

    original, lock = batched.chunked_site_solve, threading.Lock()

    def recorded(solver, n_items, bytes_per_item, device, *args, **kwargs):
        block = {"items": n_items, "bytes_per_item": bytes_per_item, "device": str(device),
                 "chunk": 0, "calls": 0}
        with lock:
            solves.append(block)

        def counted(idx):
            block["chunk"] = max(block["chunk"], int(idx.shape[0]))
            block["calls"] += 1
            return solver(idx)
        return original(counted, n_items, bytes_per_item, device, *args, **kwargs)

    batched.chunked_site_solve = recorded
    try:
        yield solves
    finally:
        batched.chunked_site_solve = original


def _check_site_table(result: dict, constant) -> dict:
    """FEL's JSON as a user reads it: headers, one row per codon, finite
    entries, p-values in [0, 1], LRT >= 0, zero rows at constant sites."""
    import numpy as np

    names = [h[0] for h in result["MLE"]["headers"]]
    check(names == ["alpha", "beta", "alpha=beta", "LRT", "p-value", "Total branch length"],
          f"FEL headers {names}")
    table = np.asarray(result["MLE"]["content"]["0"], dtype=np.float64)
    check(table.shape == (N_CODONS, 6), f"FEL site table of shape {table.shape}")
    check(bool(np.isfinite(table).all()), "non-finite entries in the FEL site table")
    p, lrt = table[:, 4], table[:, 3]
    check(bool(((p >= 0) & (p <= 1)).all()), "FEL p-values outside [0, 1]")
    check(bool((lrt >= 0).all()), "negative FEL LRT")
    check(bool((table[constant] == [0, 0, 0, 0, 1, 0]).all()),
          "constant sites without zero rows")
    for key in ("analysis", "input", "fits", "data partitions", "tested", "timers"):
        check(key in result, f"FEL JSON lacks {key!r}")
    return {"sites": int(table.shape[0]), "constant_sites": int(constant.sum()),
            "sites_p_le_0.1": int((p <= 0.1).sum()),
            "positive_p_le_0.1": int(((p <= 0.1) & (table[:, 1] > table[:, 0])).sum()),
            "max_lrt": float(lrt.max())}


def phase_main_path(torch, fasta: str, tree_path: str, tmp: str, full_fit: bool) -> dict:
    """FEL at full width as a user runs it: ``python -m hyphy_tpu_torch
    [warmup] fel``, called in-process, with the launch counts read around
    it."""
    import statistics

    from hyphy_tpu_torch import cli
    from hyphy_tpu_torch.ops.level_products import level_products

    opt_log = os.path.join(tmp, "opt.jsonl")
    out_json = os.path.join(tmp, "bench.FEL.json")
    argv = ["fel", "--alignment", fasta, "--tree", tree_path, "--output", out_json]
    if not full_fit:
        argv = ["warmup"] + argv
    os.environ["HYPHY_TPU_OPT_LOG"] = opt_log
    clock = _StageClock(torch)
    level_products.launches = 0
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        launches = level_products.launches
        clock.restore()
        del os.environ["HYPHY_TPU_OPT_LOG"]
    check(rc == 0, f"the fel command returned {rc}")
    order = ["load", "gtr", "mg94", "grid", "alt_nm", "null_nm"]
    check(sorted(clock.ends) == sorted(order), f"stages seen: {sorted(clock.ends)}")
    stamps = [t0] + [clock.ends[k] for k in order] + [t_end]
    stages = {f"{k}_s": b - a for k, a, b in zip(order + ["lrt_json"], stamps, stamps[1:])}
    stages["total_s"] = t_end - t0
    md, mg = clock.mg94_args[0], clock.mg94
    with open(out_json) as fh:
        result = json.load(fh)
    fits_json = result["fits"]
    stages.update({
        "command": " ".join(["python -m hyphy_tpu_torch"] + argv[:-1] + ["<tmp>"]),
        "iteration_cap": None if full_fit else {"lbfgs": 3, "nelder_mead": 32},
        "gtr_lnl": fits_json["Nucleotide GTR"]["Log Likelihood"],
        "mg94_lnl": fits_json["Global MG94xREV"]["Log Likelihood"],
        "level_products_launches": launches,
        "patterns": md.parts[0].codon_filter.n_patterns,
    })
    evals = clock.evals
    for nm in ("alt_nm", "null_nm"):
        n = clock.n_params[nm]
        stages[f"{nm}_iterations"] = (len(evals[nm]) - (n + 1)) // 3
    all_ms = evals["grid"] + evals["alt_nm"] + evals["null_nm"]
    stages["site_evaluations"] = {k: len(v) for k, v in evals.items()}
    stages["site_eval_ms"] = {"median": statistics.median(all_ms), "min": min(all_ms),
                              "max": max(all_ms), "mean": sum(all_ms) / len(all_ms)}
    filt = md.parts[0].codon_filter
    stages["table"] = _check_site_table(result, filt.constant_pattern_mask()[filt.duplicate_map])

    log(f"[main] {stages['command']}: {stages['total_s']:.2f} s")
    log("[main] stages, s: " + ", ".join(f"{k} {stages[f'{k}_s']:.3f}"
                                         for k in order + ["lrt_json"]))
    log(f"[main] GTR lnL {stages['gtr_lnl']:.6f}; MG94 lnL {stages['mg94_lnl']:.6f} "
        f"omega {mg.omegas.tolist()}")
    fits = _fits_from_log(opt_log)
    names = ["gtr", "cf3x4", "mg94 stage 1", "mg94 stage 2"]
    check(len(fits) == len(names), f"expected {len(names)} fits, logged {len(fits)}")
    stages["fits"] = []
    for name, fit in zip(names, fits):
        start, final = fit["trajectory"][0][0], fit["lnL"]
        log(f"[main]   {name}: start {start:.6f} -> final {final:.6f} in "
            f"{fit['iterations']} iterations, {fit['evaluations']} evaluations, "
            f"{fit['seconds']:.2f} s")
        stages["fits"].append({"name": name, "start": start, "final": final,
                               "iterations": fit["iterations"],
                               "evaluations": fit["evaluations"], "seconds": fit["seconds"]})
        check(math.isfinite(final) and final >= start, f"{name} fit ended below its start")
    log(f"[main] per-site fits of {stages['patterns']} patterns: Nelder-Mead iterations "
        f"alternative {stages['alt_nm_iterations']}, null {stages['null_nm_iterations']}; "
        f"batched evaluations {stages['site_evaluations']}; ms per evaluation "
        f"{ {k: round(v, 3) for k, v in stages['site_eval_ms'].items()} }")
    log(f"[main] site table: {stages['table']}")
    check(math.isfinite(stages["gtr_lnl"]) and math.isfinite(stages["mg94_lnl"]),
          "non-finite lnL")
    check(launches > 0, "the main path launched no level_products kernel")
    log(f"[main] level_products launches: {launches}")
    stages["data"], stages["mg94_fit"] = md.parts[0], mg.parts[0]
    return stages


def phase_parity(torch, aln, newick: str) -> dict:
    import numpy as np

    from hyphy_tpu_torch.convert import params_from_numpy
    from hyphy_tpu_torch.data.filter import DataFilter
    from hyphy_tpu_torch.data.genetic_code import GeneticCode
    from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
    from hyphy_tpu_torch.models import frequencies as freq_mod
    from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
    from hyphy_tpu_torch.models.codon import MG94xREVPartitionedOmega
    from hyphy_tpu_torch.ops import expm, pruning
    from hyphy_tpu_torch.ops.level_products import level_products
    from hyphy_tpu_torch.tree.topology import Tree

    # bench.py::build_problem, with the port
    gc = GeneticCode("Universal")
    filt = DataFilter.from_alignment(aln, "codon", genetic_code=gc)
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    corners, codon_freqs = freq_mod.f3x4(filt, gc)
    nb = tree.n_branches
    model = MG94xREVPartitionedOmega(
        gc, corners, codon_freqs,
        nuc_lengths=np.maximum(np.abs(np.asarray(tree.input_lengths[:-1])), 1e-3),
        branch_groups=np.zeros(nb, dtype=np.int32), n_groups=1, free_lengths=True,
        device=DEVICE,
    )
    specs = model.parameter_specs(nb)
    point = {k: np.full(s.shape, s.init, np.float64) for k, s in specs.items()}
    point["alpha"] = model.nuc_lengths.cpu().numpy()
    part = [Partition(filt, tree, model)]
    res = {"depth": len(tree.levels())}
    check([len(ids) for ids in tree.levels()] == LEVEL_WIDTHS,
          "phase 3's per-evaluation rows assume other level widths")
    level_products.launches = 0
    lnl = {}
    for name, dtype in (("float64", torch.float64), ("float32", torch.float32)):
        lf = LikelihoodFunction(part, dtype=dtype, device=DEVICE)
        params = params_from_numpy(point, DEVICE)
        before = level_products.launches
        with torch.no_grad():
            lnl[name] = lf.loglik(params).item()
        check(level_products.launches - before == res["depth"],
              "one evaluation should launch the kernel once per tree level")

        def value_and_grad():
            p = {k: v.detach().requires_grad_() for k, v in params.items()}
            v = lf.loglik(p)
            v.backward()
            return v

        def value():
            with torch.no_grad():
                return lf.loglik(params)

        def build():
            with torch.no_grad():
                return model.build({k: v.to(dtype) for k, v in params.items()}, nb)

        res[name] = {"lnl": lnl[name], "eval_ms": wall_ms(torch, value, 5),
                     "value_grad_ms": wall_ms(torch, value_and_grad, 5),
                     "build_ms": wall_ms(torch, build, 5),
                     "profile_value": profile_ms(
                         torch, value,
                         os.path.join("chiprun_out", f"profile_{name}_value.txt")),
                     "profile_value_grad": profile_ms(
                         torch, value_and_grad,
                         os.path.join("chiprun_out", f"profile_{name}_value_grad.txt"))}
        log(f"[parity] {name}: lnL {lnl[name]:.8f}; ms per eval "
            f"{res[name]['eval_ms']}; per value+gradient {res[name]['value_grad_ms']}; "
            f"of which model.build {res[name]['build_ms']}")
        for what in ("value", "value_grad"):
            prof = res[name][f"profile_{what}"]
            log(f"[parity] {name} {what} profiled: wall {prof['wall_ms']:.3f} ms, "
                f"kernels {prof['device_ms']:.3f} ms, device idle share "
                f"{prof['idle_share']:.3f}; top {prof['top']}")
        prof = res[name]["profile_value"]
        log(f"[parity] {name} value profiled: K1 {sum(prof['k1_launch_ms']):.4f} ms in "
            f"{len(prof['k1_launch_ms'])} launches; per launch "
            f"{[round(t, 4) for t in prof['k1_launch_ms']]}")
        if name == "float64":
            # the kernel path on the card against the plain path on the host,
            # on identical propagators and leaf partials
            # (the tree's leaves are in the filter's order)
            leaves = torch.as_tensor(filt.leaf_partials(), device=DEVICE).double()
            w = torch.as_tensor(filt.pattern_weights, device=DEVICE).double()
            schedule = pruning.build_pruning_data(tree, DEVICE)
            freqs = model.frequencies
            with torch.no_grad():
                p_mat = model.build(params, nb).p_matrices
                site_card = pruning.site_log_likelihoods(p_mat, leaves, freqs, schedule)
                site_host = pruning.site_log_likelihoods(
                    p_mat.cpu(), leaves.cpu(), freqs.cpu(),
                    pruning.build_pruning_data(tree, "cpu"))
            total_card = float(site_card @ w)
            total_host = float(site_host @ w.cpu())
            res["identical_inputs_abs_diff"] = abs(total_card - total_host)
            res["identical_inputs_max_site_diff"] = float(
                (site_card.cpu() - site_host).abs().max())
            log(f"[parity] fp64 pruning, card kernel vs host plain on identical "
                f"inputs: |dlnL| {res['identical_inputs_abs_diff']:.3e}, max site "
                f"{res['identical_inputs_max_site_diff']:.3e} (bound 1e-6)")
            check(res["identical_inputs_abs_diff"] <= 1e-6,
                  "card pruning disagrees with host pruning on identical inputs")
            # the same point with fp64 propagators from the Taylor route,
            # which keeps the tiny entries of short branches accurate
            with torch.no_grad():
                q_syn, q_non = model.basis_matrices(params)
                gen = fill_diagonal_from_rows(q_syn + params["omega"][0] * q_non)
                p_taylor = expm.shared_taylor_propagators(gen, params["alpha"])
                res["taylor_fp64_lnl"] = float(pruning.site_log_likelihoods(
                    p_taylor, leaves, freqs, schedule) @ w)
            log(f"[parity] fp64 with Taylor-route propagators: lnL "
                f"{res['taylor_fp64_lnl']:.8f} (HyPhy binary {HYPHY_LNL}: "
                f"|d| {abs(res['taylor_fp64_lnl'] - HYPHY_LNL):.3e}, bound {HYPHY_BOUND})")
            check(abs(res["taylor_fp64_lnl"] - HYPHY_LNL) <= HYPHY_BOUND,
                  "Taylor-route fp64 lnL far from the HyPhy binary's")
    res["anchor_abs_diff"] = abs(lnl["float64"] - ANCHOR_FP64)
    res["fp32_vs_fp64"] = abs(lnl["float32"] - lnl["float64"])
    res["launches"] = level_products.launches
    log(f"[parity] |lnL fp64 - JAX CPU fp64 ({ANCHOR_FP64})| = "
        f"{res['anchor_abs_diff']:.6f} (bound {ANCHOR_BOUND})")
    log(f"[parity] |lnL fp32 - lnL fp64| = {res['fp32_vs_fp64']:.6f} (bound {FP32_BOUND})")
    log(f"[parity] tree depth {res['depth']} = level_products launches per "
        f"evaluation; launches in this phase: {res['launches']}")
    check(res["anchor_abs_diff"] <= ANCHOR_BOUND, "fp64 lnL far from the JAX package's")
    check(res["fp32_vs_fp64"] <= FP32_BOUND, "fp32 lnL far from fp64")
    check(res["launches"] > 0, "the parity phase launched no kernel")
    return res


def _site_args(torch, n_sites, point, n_groups, device):
    alpha, beta = point
    f64 = dict(dtype=torch.float64, device=device)
    return (torch.arange(n_sites, device=device), torch.full((n_sites,), alpha, **f64),
            torch.full((n_sites, n_groups), beta, **f64))


def _host_fit(mgp, data):
    """The MG94 fit with its model and parameters on the host."""
    import dataclasses

    from hyphy_tpu_torch.models.codon import MG94xREVPartitionedOmega

    model = MG94xREVPartitionedOmega(
        data.genetic_code, mgp.corner_freqs, mgp.codon_freqs,
        nuc_lengths=mgp.model.nuc_lengths.cpu().numpy(), branch_groups=data.branch_groups,
        n_groups=mgp.model.n_groups, free_lengths=True,
        multiple_hits=mgp.model.multiple_hits, device="cpu")
    return dataclasses.replace(
        mgp, model=model, params={k: v.detach().cpu() for k, v in mgp.params.items()})


def _site_bound(torch, data, mgp, loglik_args, dtype, spectral):
    """Least time of one batched per-site evaluation on this run's inputs:
    the larger of its FLOPs over the card's peak for the dtype and its
    bytes — the [N, nodes, S] CLVs written once and read once, the leaf
    partials read once — over the memory rate.  FLOPs are what these sites'
    data need, each branch acting with its own group's factors.  Taylor:
    (set bits of j_sb + terms) x 2 S^2 per branch-site, plus (terms + the
    squarings up to the highest bit used) S x S products per site and
    group; spectral: 4 S^2 per branch-site plus ~9 S^3 per
    eigendecomposition.  Also returns the ladder bits each level walks (the
    batch's largest j there)."""
    import numpy as np

    from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
    from hyphy_tpu_torch.ops import expm, pruning

    _, a, betas = loglik_args
    n, n_groups = betas.shape
    s = mgp.model.n_states
    n_branches = data.tree.n_branches
    size = 8 if dtype == torch.float64 else 4
    schedule = pruning.build_pruning_data(data.tree, "cpu")
    out = {}
    if spectral:
        flops = n * n_branches * 4 * s * s + n * n_groups * 9 * s ** 3
    else:
        with torch.no_grad():
            q_syn, q_non = mgp.model.basis_matrices(mgp.params)
            m = fill_diagonal_from_rows(a[:, None, None, None] * q_syn
                                        + betas[:, :, None, None] * q_non).to(dtype)
            alpha_hat = torch.as_tensor(mgp.alphas, device=m.device).to(dtype)
            _, m2p, _, j = expm.taylor_action_factors(m, alpha_hat)
            group = torch.as_tensor(np.where(data.tested_branches, 0, 1), device=m.device)
            j = j[:, group, torch.arange(n_branches, device=m.device)].long()   # [N, B]
            depth = m2p.shape[2]
            set_bits = int(sum(((j >> k) & 1).sum() for k in range(depth)))
            j_max = j.amax(dim=0).cpu().numpy()
        terms = expm.taylor_action_terms(dtype)
        top = min(depth, int(j_max.max()).bit_length())
        flops = (2 * s * s * (set_bits + n * n_branches * terms)
                 + n * n_groups * (terms + max(top - 1, 0)) * 2 * s ** 3)
        out["ladder_bits_per_level"] = [
            min(depth, int(j_max[b[b < n_branches]].max(initial=0)).bit_length())
            for b in (lv[2].reshape(-1) for lv in schedule.ulevels)]
        out["set_bits_per_branch_site"] = set_bits / (n * n_branches)
    nbytes = n * (2 * (schedule.n_nodes + 1) + data.tree.n_leaves) * s * size
    name = "float64" if dtype == torch.float64 else "float32"
    t_ops, t_bytes = flops / PEAK_FLOPS[name], nbytes / PEAK_BYTES
    out.update(bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               flops=flops, bytes=nbytes)
    return out


def _event_and_wall_ms(torch, fn, reps: int):
    """CUDA-event time (first event to last, idle gaps included) and host
    time of each of ``reps`` calls after a warm-up, and the peak memory."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, walls = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    return {"event_ms": events, "wall_ms": walls,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_sites(torch, data, mgp) -> dict:
    """The per-site objective of phase 4's MG94 fit at points of FEL's SRV
    start grid: the card against the host on identical inputs (fp64 Taylor,
    fp64 spectral), fp32 against fp64 Taylor on the card, and the time of
    one batched evaluation of every pattern per route."""
    from hyphy_tpu_torch.methods import fel
    from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
    from hyphy_tpu_torch.ops import expm

    n_sites = data.codon_filter.n_patterns
    n_groups = 2 if (~data.tested_branches).any() else 1
    points = [tuple(float(x) for x in fel._SRV_GRID[i]) for i in SITE_GRID_ROWS]
    host = _host_fit(mgp, data)
    n_parity = min(SITE_PARITY_N, n_sites)
    res = {"patterns": n_sites, "groups": n_groups, "points": points}

    def objective(fit, dtype, spectral):
        return fel.site_log_likelihood(data, fit, dtype, spectral)

    with torch.no_grad():
        # fp64 Taylor: the whole objective, factors computed on each side
        card, cpu = (objective(mgp, torch.float64, False), objective(host, torch.float64, False))
        diffs = [float((card(*_site_args(torch, n_parity, pt, n_groups, DEVICE)).cpu()
                        - cpu(*_site_args(torch, n_parity, pt, n_groups, "cpu"))).abs().max())
                 for pt in points]
        res["taylor_fp64_card_vs_host"] = max(diffs)
        log(f"[sites]   Taylor fp64 card vs host per point: {diffs}")
        # fp64 spectral: the pruning route on identical factors (the card's
        # eigendecomposition carried to the host), and the whole objective
        # with each side's own eigh for the record
        card, cpu = (objective(mgp, torch.float64, True), objective(host, torch.float64, True))
        factors, original = [], expm.reversible_spectral

        def record(m, pi):
            factors.append(original(m, pi))
            return factors[-1]

        route, whole, res["spectral_fp64_by_point"] = [], [], []
        for pt in points:
            expm.reversible_spectral = record
            try:
                on_card = card(*_site_args(torch, n_parity, pt, n_groups, DEVICE)).cpu()
                expm.reversible_spectral = lambda m, pi: tuple(x.cpu() for x in factors[-1])
                same = cpu(*_site_args(torch, n_parity, pt, n_groups, "cpu"))
            finally:
                expm.reversible_spectral = original
            own = cpu(*_site_args(torch, n_parity, pt, n_groups, "cpu"))
            route.append(float((on_card - same).abs().max()))
            whole.append(float((on_card - own).abs().max()))
            res["spectral_fp64_by_point"].append(
                {"point": pt, "max_abs": route[-1], "own_eigh_max_abs": whole[-1],
                 "bound": SITE_SPECTRAL_BOUNDS.get(pt, SITE_HOST_BOUND)})
        res["spectral_fp64_card_vs_host"] = max(route)
        res["spectral_fp64_card_vs_host_own_eigh"] = max(whole)
        # fp32 against fp64 Taylor on the card, every pattern
        f32, f64 = objective(mgp, torch.float32, False), objective(mgp, torch.float64, False)
        gaps = []
        for pt in points:
            args = _site_args(torch, n_sites, pt, n_groups, DEVICE)
            gaps.append(float((f32(*args).double() - f64(*args)).abs().max()))
        res["taylor_fp32_vs_fp64"] = max(gaps)
    log(f"[sites] per-site lnL at SRV grid points {points}, {n_groups} branch group(s):")
    log(f"[sites]   fp64 Taylor, card vs host, {n_parity} sites: max |d| "
        f"{res['taylor_fp64_card_vs_host']:.3e} (bound {SITE_HOST_BOUND})")
    for row in res["spectral_fp64_by_point"]:
        log(f"[sites]   fp64 spectral route at {row['point']}, card vs host on identical "
            f"factors: max |d| {row['max_abs']:.3e} (bound {row['bound']}); with each "
            f"side's own eigh {row['own_eigh_max_abs']:.3e}")
    log(f"[sites]   fp32 vs fp64 Taylor on the card, {n_sites} sites: max |d| "
        f"{res['taylor_fp32_vs_fp64']:.3e} (bound {SITE_FP32_BOUND})")

    # one batched evaluation of every pattern, per route
    pt = points[0]
    args = _site_args(torch, n_sites, pt, n_groups, DEVICE)
    res["timing"] = {}
    small = _site_args(torch, min(SITE_PROFILE_N, n_sites), pt, n_groups, DEVICE)
    for name, dtype, spectral, reps in (("taylor_fp32", torch.float32, False, 5),
                                        ("taylor_fp64", torch.float64, False, 3),
                                        ("spectral_fp64", torch.float64, True, 1)):
        fn = objective(mgp, dtype, spectral)
        t0 = time.perf_counter()
        with torch.no_grad():
            row = _event_and_wall_ms(torch, lambda: fn(*args), reps)
            profiled = small if spectral else args
            row["profile"] = prof = profile_ms(
                torch, lambda: fn(*profiled),
                os.path.join("chiprun_out", f"profile_site_{name}.txt"))
            prof["sites"] = profiled[0].shape[0]
            row.update(_site_bound(torch, data, mgp, args, dtype, spectral))
        res["timing"][name] = row
        log(f"[sites] {name}, {n_sites} sites: events {[round(t, 3) for t in row['event_ms']]} "
            f"ms, wall {[round(t, 3) for t in row['wall_ms']]} ms; bound "
            f"{row['bound_ms']:.3f} ms ({row['bound_by']}); peak {row['peak_gb']:.2f} GB; "
            f"profiled on {prof['sites']} sites: wall {prof['wall_ms']:.3f} ms, kernels "
            f"{prof['device_ms']:.3f} ms in {prof['launches']} launches, idle share "
            f"{prof['idle_share']:.3f}; top {prof['top'][:3]}; "
            f"{ {k: row[k] for k in ('ladder_bits_per_level', 'set_bits_per_branch_site') if k in row} }"
            f" ({time.perf_counter() - t0:.1f} s)")
    # the eigendecomposition alone, as the spectral route calls it
    with torch.no_grad():
        q_syn, q_non = mgp.model.basis_matrices(mgp.params)
        m = fill_diagonal_from_rows(args[1][:, None, None] * q_syn
                                    + args[2][:, 0, None, None] * q_non)
        sym = m * torch.sqrt(mgp.model.frequencies)[:, None] / torch.sqrt(mgp.model.frequencies)
        sym = 0.5 * (sym + sym.transpose(-1, -2))
        row = _event_and_wall_ms(torch, lambda: torch.linalg.eigh(sym), 1)
        head = sym[: SITE_PROFILE_N]
        row["profile"] = prof = profile_ms(
            torch, lambda: torch.linalg.eigh(head),
            os.path.join("chiprun_out", "profile_site_eigh.txt"))
        prof["sites"] = head.shape[0]
    res["timing"]["eigh_fp64"] = row
    log(f"[sites] torch.linalg.eigh on {list(sym.shape)} fp64: events "
        f"{[round(t, 3) for t in row['event_ms']]} ms, wall "
        f"{[round(t, 3) for t in row['wall_ms']]} ms; profiled on {prof['sites']}: "
        f"wall {prof['wall_ms']:.3f} ms, kernels {prof['device_ms']:.3f} ms in "
        f"{prof['launches']} launches, idle share {prof['idle_share']:.3f}; top {prof['top'][:3]}")
    check(res["taylor_fp64_card_vs_host"] <= SITE_HOST_BOUND,
          "fp64 Taylor per-site lnL: card disagrees with host")
    for row in res["spectral_fp64_by_point"]:
        check(row["max_abs"] <= row["bound"],
              f"fp64 spectral per-site lnL at {row['point']}: card disagrees with host")
    check(res["taylor_fp32_vs_fp64"] <= SITE_FP32_BOUND, "fp32 per-site lnL far from fp64")
    return res


class _CallClock:
    """Phases 7 and 8's instruments, kept out of the package: wraps the
    named package functions, sums each one's seconds (ended by a
    synchronize), keeps them per call and counts the calls, keeps each
    one's first arguments and its last arguments and result; times every batched per-site evaluation handed to the grid
    search and the Nelder-Mead; and counts K1 launches per partition of the
    likelihood functions.  ``restore`` puts the package's functions back."""

    def __init__(self, torch, targets):
        from hyphy_tpu_torch.likelihood import LikelihoodFunction
        from hyphy_tpu_torch.ops.level_products import level_products

        self.torch = torch
        self.seconds, self.calls, self.last = {}, {}, {}
        self.each, self.first = {}, {}
        self.eval_ms, self.eval_by = [], {}
        self.k1_by_partition = {}
        self._saved = []
        for module, name, label in targets:
            self._patch(module, name, self._timed(getattr(module, name), label))
        partition_logliks = LikelihoodFunction._partition_site_logliks

        def counted(lf, params, i):
            before = level_products.launches
            out = partition_logliks(lf, params, i)
            self.k1_by_partition[i] = (self.k1_by_partition.get(i, 0)
                                       + level_products.launches - before)
            return out

        self._patch(LikelihoodFunction, "_partition_site_logliks", counted)

    def _patch(self, owner, name, replacement):
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, replacement)

    def _evaluations(self, objective, label):
        def wrapped(idx, params):
            t0 = time.perf_counter()
            out = objective(idx, params)
            self.torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            self.eval_ms.append(ms)
            self.eval_by.setdefault(label, []).append(ms)
            return out
        return wrapped

    def _timed(self, fn, label):
        def wrapped(*args, **kwargs):
            if label in ("grid", "nelder_mead", "profile_ci"):
                args = (self._evaluations(args[0], label),) + args[1:]
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            self.seconds[label] = self.seconds.get(label, 0.0) + seconds
            self.each.setdefault(label, []).append(seconds)
            self.first.setdefault(label, args)
            self.calls[label] = self.calls.get(label, 0) + 1
            self.last[label] = (args, out)
            return out
        return wrapped

    def restore(self):
        for owner, name, original in reversed(self._saved):
            setattr(owner, name, original)


def _run_cli(torch, argv, targets):
    """``python -m hyphy_tpu_torch`` with ``argv``, in-process, under a
    :class:`_CallClock`; K1's launch count set to 0 just before and read
    just after; peak device memory over the run."""
    from hyphy_tpu_torch import cli
    from hyphy_tpu_torch.ops.level_products import level_products

    clock = _CallClock(torch, targets)
    torch.cuda.reset_peak_memory_stats()
    level_products.launches = 0
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        launches = level_products.launches
        clock.restore()
    check(rc == 0, f"the {' '.join(argv[:2])} command returned {rc}")
    return clock, {"total_s": total, "level_products_launches": launches,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _eval_stats(ms: list) -> dict:
    import statistics

    return {"count": len(ms), "median": statistics.median(ms), "min": min(ms),
            "max": max(ms), "mean": sum(ms) / len(ms)}


def _joint_vs_one(torch, md, fit, filter_name: str) -> dict:
    """ms per evaluation (value; value and gradient) of a fit's joint
    likelihood over the partitions, and of one partition over the same
    sites (the whole alignment's filter, partition 0's tree and model), at
    the fit's parameters; K1 launches per value of each."""
    from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
    from hyphy_tpu_torch.ops.level_products import level_products

    joint = LikelihoodFunction([Partition(getattr(p, filter_name), p.tree, f.model)
                                for p, f in zip(md.parts, fit.parts)], device=DEVICE)
    joint_params = {joint.partition_key(i, k): v
                    for i, f in enumerate(fit.parts) for k, v in f.params.items()}
    whole = md.full_nuc if filter_name == "nuc_filter" else md.full_codon
    one = LikelihoodFunction([Partition(whole, md.parts[0].tree, fit.parts[0].model)],
                             device=DEVICE)
    out = {}
    for name, lf, params in (("joint", joint, joint_params), ("one", one, fit.parts[0].params)):
        params = {k: v for k, v in params.items() if k in lf.specs}

        def value():
            with torch.no_grad():
                return lf.loglik(params)

        def value_and_grad():
            p = {k: v.detach().requires_grad_() for k, v in params.items()}
            v = lf.loglik(p)
            v.backward()
            return v

        before = level_products.launches
        value()
        out[name] = {"patterns": sum(int(p.filter.n_patterns) for p in lf.partitions),
                     "k1_launches_per_value": level_products.launches - before,
                     "value_ms": wall_ms(torch, value, 5),
                     "value_grad_ms": wall_ms(torch, value_and_grad, 3)}
    return out


def _profile_last_fit(torch, clock, name: str) -> dict:
    """One batched evaluation of the last Nelder-Mead fit's objective, at
    its start, under the profiler: launches, kernel time, idle share."""
    args, _ = clock.last["nelder_mead"]
    objective, start, idx = args[0], args[2], args[3]
    with torch.no_grad():
        prof = profile_ms(torch, lambda: objective(idx, start),
                          os.path.join("chiprun_out", f"profile_{name}.txt"))
    prof["sites"] = int(idx.shape[0])
    return prof


_BASE_HEADERS = ["alpha", "beta", "alpha=beta", "LRT", "p-value", "Total branch length"]


def phase_partitions(torch, aln, newick: str, tmp: str, full_fit: bool) -> dict:
    """FEL with CHARSET partitions and Double+Triple hits at full width,
    through the CLI in-process; then the per-site objective with per-site
    delta/psi, card against host."""
    import numpy as np

    from hyphy_tpu_torch.methods import common, fel

    nexus = os.path.join(tmp, "parts.nex")
    width = 3 * PART_CODONS
    with open(nexus, "w") as fh:
        fh.write(f"#NEXUS\nBEGIN DATA;\nDIMENSIONS NTAX={len(aln.names)} "
                 f"NCHAR={len(aln.sequences[0])};\nFORMAT DATATYPE=DNA;\nMATRIX\n")
        fh.write("".join(f"{n} {s}\n" for n, s in zip(aln.names, aln.sequences)))
        fh.write(";\nEND;\nBEGIN ASSUMPTIONS;\n")
        fh.write("".join(f"CHARSET part{k} = {k * width + 1}-{(k + 1) * width};\n"
                         for k in range(N_PARTS)))
        fh.write("END;\nBEGIN TREES;\n")
        fh.write("".join(f"TREE tree{k} = {newick};\n" for k in range(N_PARTS)))
        fh.write("END;\n")
    out_json = os.path.join(tmp, "parts.FEL.json")
    argv = ["fel", "--alignment", nexus, "--output", out_json,
            "--multiple-hits", "Double+Triple", "--site-multihit", "Estimate"]
    if not full_fit:
        argv = ["warmup"] + argv
    clock, res = _run_cli(torch, argv, [
        (common, "load_codon_data_multi", "load"),
        (common, "fit_gtr_multi", "gtr"),
        (common, "fit_partitioned_mg94_multi", "mg94"),
        (fel, "solve_partition", "per_site"),
        (fel, "grid_best_starts", "grid"),
        (fel, "vmapped_nelder_mead", "nelder_mead"),
    ])
    with open(out_json) as fh:
        result = json.load(fh)
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    res["calls"] = dict(clock.calls)
    res["site_eval_ms"] = _eval_stats(clock.eval_ms)
    res["k1_launches_by_partition"] = {str(k): v for k, v in sorted(clock.k1_by_partition.items())}
    md = clock.last["mg94"][0][0]
    mg = clock.last["mg94"][1]
    res["gtr_lnl"] = result["fits"]["Nucleotide GTR"]["Log Likelihood"]
    res["mg94_lnl"] = result["fits"]["Global MG94xREV"]["Log Likelihood"]
    res["delta"] = float(mg.parts[0].params["delta"])
    res["psi"] = float(mg.parts[0].params["psi"])
    res["omega"] = mg.omegas.tolist()

    # the JSON as a user reads it
    headers = [h[0] for h in result["MLE"]["headers"]]
    check(headers == _BASE_HEADERS + ["2H rate", "3H rate"], f"FEL headers {headers}")
    check(result["input"]["partition count"] == N_PARTS
          and sorted(result["MLE"]["content"]) == [str(k) for k in range(N_PARTS)],
          "FEL JSON without one block per partition")
    tables = [np.asarray(result["MLE"]["content"][str(k)], dtype=np.float64)
              for k in range(N_PARTS)]
    for k, table in enumerate(tables):
        check(table.shape == (PART_CODONS, len(headers)),
              f"partition {k}: site table of shape {table.shape}")
        check(bool(np.isfinite(table).all()), f"partition {k}: non-finite entries")
        check(bool(((table[:, 4] >= 0) & (table[:, 4] <= 1)).all()),
              f"partition {k}: p-values outside [0, 1]")
        check(bool(((table[:, 6:8] >= 0) & (table[:, 6:8] <= 100)).all()),
              f"partition {k}: 2H/3H rates outside [0, 100]")
    check(0.0 <= res["delta"] <= 100.0 and 0.0 <= res["psi"] <= 100.0,
          "global delta/psi outside [0, 100]")
    check(math.isfinite(res["gtr_lnl"]) and math.isfinite(res["mg94_lnl"]), "non-finite lnL")
    check(sorted(clock.k1_by_partition) == list(range(N_PARTS))
          and all(v > 0 for v in clock.k1_by_partition.values()),
          f"K1 not launched on every partition: {clock.k1_by_partition}")
    res["table"] = {"sites": sum(t.shape[0] for t in tables),
                    "sites_p_le_0.1": int(sum((t[:, 4] <= 0.1).sum() for t in tables)),
                    "median_2h": float(np.median(np.concatenate([t[:, 6] for t in tables]))),
                    "median_3h": float(np.median(np.concatenate([t[:, 7] for t in tables])))}
    # the joint fits' evaluations against one partition over the same sites
    # (K1 launched here is not counted in the main path's launches above)
    res["joint_vs_one"] = {
        "gtr": _joint_vs_one(torch, clock.last["gtr"][0][0], clock.last["gtr"][1], "nuc_filter"),
        "mg94": _joint_vs_one(torch, md, mg, "codon_filter")}
    for name, row in res["joint_vs_one"].items():
        log(f"[parts] {name} evaluation, joint over {N_PARTS} partitions vs one partition on "
            f"the same sites: " + "; ".join(
                f"{k}: {r['patterns']} patterns, {r['k1_launches_per_value']} K1 launches, "
                f"value ms {[round(t, 2) for t in r['value_ms']]}, value+gradient ms "
                f"{[round(t, 2) for t in r['value_grad_ms']]}" for k, r in row.items()))
    res["profile_eval"] = prof = _profile_last_fit(torch, clock, "parts_site_eval")
    log(f"[parts] one batched evaluation of the last fit ({prof['sites']} sites) profiled: "
        f"wall {prof['wall_ms']:.3f} ms, kernels {prof['device_ms']:.3f} ms in "
        f"{prof['launches']} launches, idle share {prof['idle_share']:.3f}; top {prof['top'][:3]}")
    log(f"[parts] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items()))
    log(f"[parts] joint GTR lnL {res['gtr_lnl']:.6f}; joint MG94 (Double+Triple) lnL "
        f"{res['mg94_lnl']:.6f}, omega {res['omega']}, delta {res['delta']:.6f}, "
        f"psi {res['psi']:.6f}")
    log(f"[parts] K1 launches {res['level_products_launches']}, by partition "
        f"{res['k1_launches_by_partition']}; peak {res['peak_gb']:.2f} GB; batched site "
        f"evaluations of {PART_CODONS} patterns: "
        f"{ {k: round(v, 3) for k, v in res['site_eval_ms'].items()} } ms; "
        f"calls {res['calls']}; table {res['table']}")

    # per-site objective with per-site delta/psi, fp64 Taylor, card vs host
    data, mgp = md.parts[0], mg.parts[0]
    host = _host_fit(mgp, data)
    n = min(SITE_PARITY_N, data.codon_filter.n_patterns)
    card = fel.site_log_likelihood(data, mgp, torch.float64, False, per_site_multihit=True)
    cpu = fel.site_log_likelihood(data, host, torch.float64, False, per_site_multihit=True)
    diffs = []
    with torch.no_grad():
        for point in MH_SITE_POINTS:
            values = []
            for fn, device in ((card, DEVICE), (cpu, "cpu")):
                idx, a, betas = _site_args(torch, n, point[:2], 1, device)
                rates = [torch.full((n,), x, dtype=torch.float64, device=device)
                         for x in point[2:]]
                values.append(fn(idx, a, betas, *rates).cpu())
            diffs.append(float((values[0] - values[1]).abs().max()))
    res["multihit_site_card_vs_host"] = dict(zip(map(str, MH_SITE_POINTS), diffs))
    log(f"[parts] per-site lnL with per-site delta/psi, fp64 Taylor, card vs host, {n} "
        f"sites, at (alpha, beta, delta, psi) {MH_SITE_POINTS}: max |d| {diffs} "
        f"(bound {SITE_HOST_BOUND})")
    check(max(diffs) <= SITE_HOST_BOUND, "per-site multi-hit lnL: card disagrees with host")
    return res


def phase_options(torch, tmp: str) -> dict:
    """``warmup fel --ci Yes --resample 10`` on CI_TAXA taxa x 128 codons
    through the CLI in-process: the CI's and the bootstrap's seconds apart,
    and the columns checked.  Capped under ``--full-fit`` too: the profile's
    61 Nelder-Mead fits at their uncapped 80 iterations would take 2.5x the
    capped CI, more than the run has."""
    import numpy as np

    from hyphy_tpu_torch.methods import fel
    from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment

    from hyphy_tpu_torch.tree.topology import Tree

    aln = synthetic_codon_alignment(CI_TAXA, CI_CODONS, seed=SEED)
    fasta = os.path.join(tmp, "ci.fasta")
    with open(fasta, "w") as fh:
        fh.write("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    tree_path = os.path.join(tmp, "ci.nwk")
    with open(tree_path, "w") as fh:
        fh.write(random_tree_newick(CI_TAXA, seed=SEED))
    levels = len(Tree.from_newick(random_tree_newick(CI_TAXA, seed=SEED)).levels())
    out_json = os.path.join(tmp, "ci.FEL.json")
    argv = ["warmup", "fel", "--alignment", fasta, "--tree", tree_path, "--output", out_json,
            "--ci", "Yes", "--resample", str(N_RESAMPLE)]
    clock, res = _run_cli(torch, argv, [
        (fel, "solve_partition", "per_site"),
        (fel, "_profile_ci", "ci"),
        (fel, "_simulate_null_states", "bootstrap_simulation"),
        (fel, "_bootstrap_pvalues", "bootstrap_refits"),
        (fel, "vmapped_nelder_mead", "nelder_mead"),
    ])
    with open(out_json) as fh:
        result = json.load(fh)
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    res["calls"] = dict(clock.calls)
    res["site_eval_ms"] = _eval_stats(clock.eval_ms)
    headers = [h[0] for h in result["MLE"]["headers"]]
    check(headers == _BASE_HEADERS + ["dN/dS LB", "dN/dS MLE", "dN/dS UB", "p-asmp"],
          f"FEL headers {headers}")
    table = np.asarray(result["MLE"]["content"]["0"], dtype=np.float64)
    check(table.shape == (CI_CODONS, len(headers)), f"site table of shape {table.shape}")
    check(bool(np.isfinite(table).all()), "non-finite entries in the site table")
    lb, mle, ub = table[:, 6], table[:, 7], table[:, 8]
    check(bool(((lb <= mle) & (mle <= ub)).all()), "CI without LB <= MLE <= UB")
    p, step = table[:, 4], 1.0 / (N_RESAMPLE + 1)
    check(bool(np.allclose(np.round(p / step) * step, p, rtol=0, atol=1e-12)
               and (p >= step - 1e-12).all() and (p <= 1.0).all()),
          f"bootstrap p-values not multiples of 1/{N_RESAMPLE + 1} in [1/{N_RESAMPLE + 1}, 1]")
    check(bool(((table[:, 9] >= 0) & (table[:, 9] <= 1)).all()), "p-asmp outside [0, 1]")
    res["table"] = {"sites": int(table.shape[0]), "bootstrap_p_le_0.1": int((p <= 0.1).sum()),
                    "asymptotic_p_le_0.1": int((table[:, 9] <= 0.1).sum()),
                    "ci_width_median": float(np.median(ub - lb)),
                    "ub_at_cap": int((ub >= 10000.0).sum()), "lb_at_zero": int((lb == 0).sum())}
    res["profile_eval"] = prof = _profile_last_fit(torch, clock, "ci_site_eval")
    res["taxa"], res["tree_levels"] = CI_TAXA, levels
    log(f"[options] {CI_TAXA} taxa, {levels} tree levels; one batched evaluation of the last CI "
        f"fit ({prof['sites']} sites) profiled: "
        f"wall {prof['wall_ms']:.3f} ms, kernels {prof['device_ms']:.3f} ms in "
        f"{prof['launches']} launches, idle share {prof['idle_share']:.3f}; top {prof['top'][:3]}")
    log(f"[options] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items())
        + f"; calls {res['calls']}")
    log(f"[options] K1 launches {res['level_products_launches']}; peak {res['peak_gb']:.2f} GB; "
        f"batched site evaluations: "
        f"{ {k: round(v, 3) for k, v in res['site_eval_ms'].items()} } ms; table {res['table']}")
    return res


def phase_fused_probes(torch, data, mgp) -> dict:
    """The Nelder-Mead's fused four-probe body against its three
    sequential probes on phase 6's objective (fp32 Taylor, FEL's
    alternative at phase 4's MG94 fit) at FUSED_SITES sites: ms per
    iteration, kernel launches per iteration, peak memory; the two results
    held equal bit for bit."""
    from hyphy_tpu_torch.methods import fel
    from hyphy_tpu_torch.models.parameters import ParamSpec
    from hyphy_tpu_torch.optimize.nelder_mead import vmapped_nelder_mead

    loglik = fel.site_log_likelihood(data, mgp, torch.float32, False)
    n_groups = 2 if (~data.tested_branches).any() else 1
    specs = {k: ParamSpec(init=1.0, lower=0.0, upper=10000.0) for k in ("alpha", "beta")}

    def objective(idx, p):
        return loglik(idx, p["alpha"], p["beta"][:, None].expand(-1, n_groups))

    res = {"iterations": FUSED_ITERATIONS, "rows": []}
    for n in FUSED_SITES:
        n = min(n, data.codon_filter.n_patterns)
        idx = torch.arange(n, device=DEVICE)
        start = {k: torch.full((n,), v, dtype=torch.float64, device=DEVICE)
                 for k, v in (("alpha", 1.0), ("beta", 0.5))}
        out = {}
        for fused in (False, True):
            def run(iterations):
                with torch.no_grad():
                    return vmapped_nelder_mead(objective, specs, start, idx,
                                               max_iterations=iterations, fused=fused)

            t_init = min(wall_ms(torch, lambda: run(0), 2))
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, values = run(FUSED_ITERATIONS)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() / 1e9
            prof = profile_ms(torch, lambda: run(2), os.path.join(
                "chiprun_out", f"profile_nm_{'fused' if fused else 'sequential'}_{n}.txt"))
            prof0 = profile_ms(torch, lambda: run(0), os.path.join(
                "chiprun_out", f"profile_nm_init_{n}.txt"))
            out[fused] = (params, values)
            res["rows"].append({
                "sites": n, "fused": fused,
                "ms_per_iteration": (total - t_init) / FUSED_ITERATIONS,
                "launches_per_iteration": (prof["launches"] - prof0["launches"]) / 2,
                "kernel_ms_per_iteration": (prof["device_ms"] - prof0["device_ms"]) / 2,
                "peak_gb": peak})
            row = res["rows"][-1]
            log(f"[fused] {n} sites, {'fused' if fused else 'sequential'} probes: "
                f"{row['ms_per_iteration']:.3f} ms per iteration ({row['kernel_ms_per_iteration']:.3f} "
                f"ms of kernels in {row['launches_per_iteration']:.0f} launches), peak "
                f"{row['peak_gb']:.2f} GB")
        same = all(torch.equal(out[True][0][k], out[False][0][k]) for k in specs) and torch.equal(
            out[True][1], out[False][1])
        res.setdefault("identical", []).append(bool(same))
        check(same, f"fused and sequential Nelder-Mead differ at {n} sites")
    log(f"[fused] fused and sequential results identical at {FUSED_SITES}: {res['identical']}")
    return res


def _write_fasta(path, names, seqs):
    with open(path, "w") as fh:
        fh.write("".join(f">{n}\n{s}\n" for n, s in zip(names, seqs)))


def _planted_alignment(tmp: str):
    """``simulated_codon_alignment(N_TAXA, N_CODONS, seed=SEED)`` with
    omega = PLANTED_OMEGA at PLANTED_SITES (0.3 elsewhere), as FASTA and
    newick files."""
    import numpy as np

    from hyphy_tpu_torch.utils.synth import simulated_codon_alignment

    omegas = np.full(N_CODONS, 0.3)
    omegas[PLANTED_SITES] = PLANTED_OMEGA
    t0 = time.perf_counter()
    aln, newick = simulated_codon_alignment(N_TAXA, N_CODONS, seed=SEED, site_omegas=omegas)
    fasta = os.path.join(tmp, "sim.fasta")
    _write_fasta(fasta, aln.names, aln.sequences)
    tree_path = os.path.join(tmp, "sim.nwk")
    with open(tree_path, "w") as fh:
        fh.write(newick)
    log(f"[slac] simulated_codon_alignment({N_TAXA}, {N_CODONS}, seed={SEED}), omega "
        f"{PLANTED_OMEGA} at codons {PLANTED_SITES}: {time.perf_counter() - t0:.2f} s on the host")
    return aln, fasta, tree_path


def phase_slac(torch, fasta: str, tree_path: str, tmp: str) -> dict:
    """SLAC at full width through ``warmup slac --samples SLAC_SAMPLES``,
    in-process: seconds per stage, peak memory, K1 launches; the card's
    fp64 joint reconstruction against the host's on identical inputs
    (SLAC_HOST_PATTERNS patterns), fp32's share of equal states; the JSON."""
    import numpy as np

    from hyphy_tpu_torch.methods import common, slac
    from hyphy_tpu_torch.ops import ancestral, pruning

    out_json = os.path.join(tmp, "sim.SLAC.json")
    argv = ["warmup", "slac", "--alignment", fasta, "--tree", tree_path, "--output", out_json,
            "--samples", str(SLAC_SAMPLES)]
    clock, res = _run_cli(torch, argv, [
        (common, "load_codon_data_multi", "load"),
        (common, "fit_gtr_multi", "gtr"),
        (common, "fit_partitioned_mg94_multi", "mg94"),
        (ancestral, "joint_reconstruct", "joint_reconstruction"),
        (slac, "compute_counts", "counts"),
        (ancestral, "sample_ancestors", "sampling"),
    ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    res["calls"] = dict(clock.calls)
    with open(out_json) as fh:
        result = json.load(fh)
    headers = [h[0] for h in result["MLE"]["headers"]]
    check(headers == [c[0] for c in slac.COLUMNS], f"SLAC headers {headers}")
    tables = {key: np.asarray(result["MLE"]["content"]["0"]["by-site"][key], dtype=np.float64)
              for key in ("RESOLVED", "AVERAGED")}
    for key, table in tables.items():
        check(table.shape == (N_CODONS, len(headers)), f"SLAC {key} of shape {table.shape}")
        check(bool(np.isfinite(table).all()), f"non-finite entries in SLAC {key}")
    # the extended binomial tail (slac.extendedBinTail, copied as it is) of
    # a non-integer count is not held to [0, 1]; its range is recorded
    res["binomial_p_range"] = [float(tables["RESOLVED"][:, 8:10].min()),
                               float(tables["RESOLVED"][:, 8:10].max())]
    q = {key: np.asarray(result[key]["0"]["by-site"]["RESOLVED"], dtype=np.float64)
         for key in ("sample-2.5", "sample-median", "sample-97.5")}
    for key, table in q.items():
        check(table.shape == (N_CODONS, len(headers)) and bool(np.isfinite(table).all()),
              f"SLAC {key}: shape {table.shape} or non-finite entries")
    check(bool((q["sample-2.5"] <= q["sample-median"] + 1e-12).all()
               and (q["sample-median"] <= q["sample-97.5"] + 1e-12).all()),
          "SLAC sample quantiles out of order")
    resolved = tables["RESOLVED"]
    res["table"] = {"sites": int(resolved.shape[0]),
                    "p_dnds_gt_1_le_0.1": int((resolved[:, 8] <= 0.1).sum()),
                    "planted_p_le_0.1": int((resolved[PLANTED_SITES, 8] <= 0.1).sum()),
                    "median_subs": float(np.median(resolved[:, 2] + resolved[:, 3]))}

    # the card's fp64 joint reconstruction against the host's on identical
    # inputs (the card's propagators and leaf partials), and fp32's states
    (p_mat, lp, freqs, schedule), joint = clock.last["joint_reconstruction"]
    tree = clock.last["mg94"][0][0].parts[0].tree
    h = min(SLAC_HOST_PATTERNS, lp.shape[1])
    with torch.no_grad():
        host = ancestral.joint_reconstruct(p_mat.cpu(), lp[:, :h].cpu(), freqs.cpu(),
                                           pruning.build_pruning_data(tree, "cpu"))
        t0 = time.perf_counter()
        f32 = ancestral.joint_reconstruct(p_mat.float(), lp.float(), freqs.float(), schedule)
        torch.cuda.synchronize()
        f32_s = time.perf_counter() - t0
    card_states = joint.internal_states.cpu()
    res["fp64_states_card_vs_host_equal"] = bool(torch.equal(card_states[:, :h], host.internal_states))
    card_lnl = joint.root_loglik[:h].cpu()
    res["fp64_root_lnl_max_rel"] = float(((card_lnl - host.root_loglik).abs()
                                          / host.root_loglik.abs()).max())
    res["fp32_states_equal_share"] = float((f32.internal_states.cpu() == card_states)
                                           .double().mean())
    res["fp32_joint_s"] = f32_s
    res["host_patterns"] = h
    log(f"[slac] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items()) + f"; calls {res['calls']}")
    log(f"[slac] K1 launches {res['level_products_launches']}; peak {res['peak_gb']:.2f} GB; "
        f"table {res['table']}; binomial p range {res['binomial_p_range']}")
    log(f"[slac] fp64 joint reconstruction, card vs host on identical inputs ({h} patterns): "
        f"states equal {res['fp64_states_card_vs_host_equal']}, root lnL max rel "
        f"{res['fp64_root_lnl_max_rel']:.3e} (bound {SLAC_LNL_REL_BOUND}); fp32 on the card: "
        f"{res['fp32_states_equal_share']:.6f} of the states equal to fp64's "
        f"({f32_s:.3f} s)")
    check(res["fp64_states_card_vs_host_equal"], "SLAC fp64 states: card differs from host")
    check(res["fp64_root_lnl_max_rel"] <= SLAC_LNL_REL_BOUND,
          "SLAC root lnL: card differs from host")
    check(res["level_products_launches"] > 0, "SLAC launched no level_products kernel")
    return res


def phase_simulate(torch, aln, fasta: str, tree_path: str, tmp: str) -> dict:
    """``warmup simulate --replicates 2`` on phase 9's alignment through the
    CLI in-process: the replicates have the input's taxa and codons."""
    from hyphy_tpu_torch.data.alignment import read_alignment
    from hyphy_tpu_torch.methods import common, simulate

    out_json = os.path.join(tmp, "replicates.json")
    argv = ["warmup", "simulate", "--alignment", fasta, "--tree", tree_path,
            "--output", out_json, "--replicates", "2", "--seed", "3"]
    clock, res = _run_cli(torch, argv, [
        (common, "load_codon_data", "load"),
        (common, "fit_gtr", "gtr"),
        (common, "fit_partitioned_mg94", "mg94"),
        (simulate, "simulate_states", "simulation"),
    ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    with open(out_json) as fh:
        files = json.load(fh)["files"]
    check(len(files) == 2, f"simulate wrote {files}")
    for path in files:
        rep = read_alignment(path)
        check(sorted(rep.names) == sorted(aln.names), f"{path}: other taxa")
        check({len(s) for s in rep.sequences} == {3 * N_CODONS}, f"{path}: other length")
    res["replicates"] = len(files)
    log(f"[simulate] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items())
        + f"; K1 launches {res['level_products_launches']}; peak {res['peak_gb']:.2f} GB; "
        f"{len(files)} replicates of {N_TAXA} taxa x {N_CODONS} codons")
    check(res["level_products_launches"] > 0, "simulate launched no level_products kernel")
    return res


def phase_meme(torch, aln, tree_path: str, tmp: str) -> dict:
    """MEME on phase 9's alignment cut to MEME_CODONS codons through
    ``warmup meme``, in-process: seconds per stage, the EBF's items and
    chunks, K1 launches; one batched mixture evaluation timed; the mixture
    site lnL card vs host (fp64 Taylor) and fp32 vs fp64; the planted
    sites' calls; the EBF split held bit for bit."""
    import numpy as np

    from hyphy_tpu_torch.methods import common, meme
    from hyphy_tpu_torch.optimize import batched

    fasta = os.path.join(tmp, "meme.fasta")
    _write_fasta(fasta, aln.names, [s[: 3 * MEME_CODONS] for s in aln.sequences])
    out_json = os.path.join(tmp, "meme.MEME.json")
    argv = ["warmup", "meme", "--alignment", fasta, "--tree", tree_path, "--output", out_json]
    with _recorded_solves([]) as solves:
        clock, res = _run_cli(torch, argv, [
            (common, "load_codon_data_multi", "load"),
            (common, "fit_gtr_multi", "gtr"),
            (common, "fit_partitioned_mg94_multi", "mg94"),
            (meme, "_fel_stage", "fel"),
            (meme, "_candidate_starts", "candidates"),
            (meme, "_alternative_stage", "alternative"),
            (meme, "_null_stage", "null"),
            (meme, "branch_ebfs", "ebf"),
            (meme, "vmapped_nelder_mead", "nelder_mead"),
        ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    res["calls"] = dict(clock.calls)
    res["site_eval_ms"] = _eval_stats(clock.eval_ms)
    ebf_solve = solves[-1]
    res["ebf_items"] = ebf_solve["items"]
    res["ebf_chunk"] = ebf_solve["chunk"]
    res["ebf_chunks"] = -(-ebf_solve["items"] // ebf_solve["chunk"])
    res["solves"] = solves
    with open(out_json) as fh:
        result = json.load(fh)
    headers = [h[0] for h in result["MLE"]["headers"]]
    check(headers[:3] == ["&alpha;", "&beta;<sup>1</sup>", "p<sup>1</sup>"]
          and headers[-2:] == ["FEL &alpha;", "FEL &beta;"], f"MEME headers {headers}")
    table = np.asarray(result["MLE"]["content"]["0"], dtype=np.float64)
    check(table.shape == (MEME_CODONS, len(headers)), f"MEME table of shape {table.shape}")
    check(bool(np.isfinite(table).all()), "non-finite entries in the MEME table")
    p = table[:, headers.index("p-value")]
    check(bool(((p >= 0) & (p <= 1)).all()), "MEME p-values outside [0, 1]")
    planted = [s for s in PLANTED_SITES if s < MEME_CODONS]
    res["table"] = {"sites_p_le_0.1": int((p <= 0.1).sum()), "planted": planted,
                    "planted_p": p[planted].tolist(),
                    "branches_under_selection_max": float(
                        table[:, headers.index("# branches under selection")].max())}
    check(bool((p[planted] <= 0.1).all()), f"planted sites not at p <= 0.1: {p[planted]}")

    # one batched mixture evaluation of every pattern, at the stage's starts
    sites, _, idx, starts = clock.last["alternative"][0]
    with torch.no_grad():
        row = _event_and_wall_ms(torch, lambda: sites.loglik(idx, starts), 3)
        row["profile"] = profile_ms(torch, lambda: sites.loglik(idx, starts),
                                    os.path.join("chiprun_out", "profile_meme_mixture.txt"))
    row["sites"] = int(idx.shape[0])
    res["mixture_eval"] = row
    prof = row["profile"]
    log(f"[meme] one batched mixture evaluation ({row['sites']} sites, fp32 Taylor, "
        f"{sites.rate_classes + 1} families): events {[round(t, 3) for t in row['event_ms']]} ms, "
        f"wall {[round(t, 3) for t in row['wall_ms']]} ms, peak {row['peak_gb']:.2f} GB; profiled: "
        f"wall {prof['wall_ms']:.3f} ms, kernels {prof['device_ms']:.3f} ms in {prof['launches']} "
        f"launches, idle share {prof['idle_share']:.3f}; top {prof['top'][:3]}")

    # card vs host on identical inputs: the mixture site lnL, fp64 Taylor
    md, mg = clock.last["mg94"][0][0], clock.last["mg94"][1]
    data, mgp = md.parts[0], mg.parts[0]
    alt = clock.last["alternative"][1]
    n = min(SITE_PARITY_N, idx.shape[0])
    point = {k: v[:n] for k, v in alt.items() if k != "lnl"}
    with torch.no_grad():
        card64 = meme.mixture_sites(data, mgp, torch.float64, False, sites.rate_classes)
        host64 = meme.mixture_sites(data, _host_fit(mgp, data), torch.float64, False,
                                    sites.rate_classes)
        on_card = card64.loglik(idx[:n], point).cpu()
        on_host = host64.loglik(idx[:n].cpu(), {k: v.cpu() for k, v in point.items()})
        res["mixture_fp64_card_vs_host"] = float((on_card - on_host).abs().max())
        card32 = meme.mixture_sites(data, mgp, torch.float32, False, sites.rate_classes)
        full = {k: v for k, v in alt.items() if k != "lnl"}
        rows = torch.arange(alt["lnl"].shape[0], device=DEVICE)
        res["mixture_fp32_vs_fp64"] = float(
            (card32.loglik(rows, full).double() - card64.loglik(rows, full)).abs().max())
    log(f"[meme] mixture site lnL, fp64 Taylor, card vs host on {n} sites: max |d| "
        f"{res['mixture_fp64_card_vs_host']:.3e} (bound {SITE_HOST_BOUND}); fp32 vs fp64 on "
        f"{rows.shape[0]} sites: {res['mixture_fp32_vs_fp64']:.3e} (bound {SITE_FP32_BOUND})")
    check(res["mixture_fp64_card_vs_host"] <= SITE_HOST_BOUND,
          "MEME mixture site lnL: card disagrees with host")
    check(res["mixture_fp32_vs_fp64"] <= SITE_FP32_BOUND, "MEME fp32 mixture lnL far from fp64")

    # the EBF split: the same sites in one chunk, in the run's chunks and in
    # forced small chunks give the same EBFs bit for bit
    tested_idx = np.nonzero(data.tested_branches)[0]
    per_site = len(tested_idx) * (sites.rate_classes - 1)
    one_chunk = batched.site_chunk(SPLIT_SITES * per_site, sites.item_bytes, DEVICE)
    n_one = max(1, min(SPLIT_SITES, one_chunk // per_site))
    split, res["split"] = {}, {}
    for label, n_sites, chunk in (("one_chunk", n_one, n_one * per_site),
                                  ("one_chunk_forced", n_one, SPLIT_CHUNK),
                                  ("free_memory", SPLIT_SITES, None),
                                  ("forced", SPLIT_SITES, SPLIT_CHUNK)):
        items = n_sites * per_site
        chunk = chunk or batched.site_chunk(items, sites.item_bytes, DEVICE)
        sub = {k: v[:n_sites] for k, v in alt.items()}
        t0 = time.perf_counter()
        with torch.no_grad():
            split[label] = meme.branch_ebfs(sites, sub, tested_idx, sites_idx=idx[:n_sites],
                                            chunk=chunk)
        torch.cuda.synchronize()
        res["split"][label] = {"sites": n_sites, "items": items, "chunk": chunk,
                               "chunks": -(-items // chunk), "s": time.perf_counter() - t0}
    res["split"]["one_chunk_equal"] = bool(np.array_equal(split["one_chunk"],
                                                          split["one_chunk_forced"],
                                                          equal_nan=True))
    res["split"]["equal"] = bool(np.array_equal(split["free_memory"], split["forced"],
                                                equal_nan=True))
    log(f"[meme] EBF split: {res['split']}")
    check(res["split"]["one_chunk_equal"] and res["split"]["equal"],
          "MEME EBFs differ between chunkings")
    log(f"[meme] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items()) + f"; calls {res['calls']}")
    log(f"[meme] EBF items {res['ebf_items']} in {res['ebf_chunks']} chunks of "
        f"{res['ebf_chunk']}; K1 launches {res['level_products_launches']}; peak "
        f"{res['peak_gb']:.2f} GB; batched site evaluations "
        f"{ {k: round(v, 3) for k, v in res['site_eval_ms'].items()} } ms; table {res['table']}")
    check(res["level_products_launches"] > 0, "MEME launched no level_products kernel")
    return res


def _cut_fasta(aln, path: str, codons: int) -> str:
    _write_fasta(path, aln.names, [s[: 3 * codons] for s in aln.sequences])
    return path


def phase_fubar(torch, fasta: str, tree_path: str, tmp: str) -> dict:
    """FUBAR at full width on phase 9's alignment through ``warmup fubar
    --grid GRID_POINTS`` (Variational-Bayes), in-process: seconds per stage
    (load, GTR, the two grid passes, the posterior), grid points per chunk,
    K1 launches, peak memory; fp32 against fp64 on GRID_FP32_POINTS, the
    folded grid form against the one-set form on GRID_FOLD_POINTS, the
    posterior's sum, the planted codons' P[beta > alpha], the JSON."""
    import dataclasses

    import numpy as np

    from hyphy_tpu_torch.methods import common, fubar
    from hyphy_tpu_torch.ops import pruning

    out_json = os.path.join(tmp, "sim.FUBAR.json")
    argv = ["warmup", "fubar", "--alignment", fasta, "--tree", tree_path, "--output", out_json,
            "--grid", str(GRID_POINTS)]
    with _recorded_solves([]) as chunks:
        clock, res = _run_cli(torch, argv, [
            (common, "load_codon_data", "load"),
            (common, "fit_gtr", "gtr"),
            (fubar, "grid_pass", "grid_pass"),
            (fubar, "posterior_over_grid", "posterior"),
        ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    res["grid_pass_s"] = clock.each["grid_pass"]
    res["chunks"] = chunks
    with open(out_json) as fh:
        result = json.load(fh)
    headers = [h[0] for h in result["MLE"]["headers"]]
    table = np.asarray(result["MLE"]["content"]["0"], dtype=np.float64)
    grid = np.asarray(result["grid"], dtype=np.float64)
    check(headers[:2] == ["alpha", "beta"] and table.shape == (N_CODONS, 6),
          f"FUBAR headers {headers}, table {table.shape}")
    check(grid.shape == (GRID_POINTS ** 2, 3), f"FUBAR grid of shape {grid.shape}")
    check(bool(np.isfinite(table).all()), "non-finite entries in the FUBAR table")
    res["posterior_sum"] = float(grid[:, 2].sum())
    check(abs(res["posterior_sum"] - 1.0) <= 1e-9, f"posterior weights sum to {res['posterior_sum']}")
    p_pos = table[:, headers.index("Prob[alpha<beta]")]
    res["planted_p_pos"] = p_pos[PLANTED_SITES].tolist()
    res["sites_p_pos_ge_0.9"] = int((p_pos >= 0.9).sum())

    # the grid pass on the card: fp32 Taylor against fp64 spectral, and the
    # folded grid form against the one-set form, on pass 2's branch scales
    (gp, grid_t, times), sll32 = clock.last["grid_pass"]
    gp64 = dataclasses.replace(gp, leaves=gp.leaves.double(), dtype=torch.float64)
    with torch.no_grad():
        pts = torch.as_tensor(GRID_FP32_POINTS, device=DEVICE)
        p64 = gp64.propagators(grid_t[pts], times)
        sll64 = pruning.site_log_likelihoods(p64, gp64.leaves, gp64.freqs, gp64.schedule)
        res["fp32_vs_fp64"] = float((sll32[pts] - sll64).abs().max())
        fold = torch.as_tensor(GRID_FOLD_POINTS, device=DEVICE)
        p32 = gp.propagators(grid_t[fold], times)
        freqs = gp.freqs.to(gp.dtype)
        folded = pruning.site_log_likelihoods(p32, gp.leaves, freqs, gp.schedule)
        alone = torch.cat([pruning.site_log_likelihoods(p32[g:g + 1], gp.leaves, freqs,
                                                        gp.schedule) for g in range(len(fold))])
        one_set = torch.stack([pruning.site_log_likelihoods(p32[g], gp.leaves, freqs, gp.schedule)
                               for g in range(len(fold))])
    # one grid-form pruning of four points on the pass's fp32 route, profiled
    with torch.no_grad():
        p_four = gp.propagators(grid_t[pts], times)
        res["profile_grid"] = prof = profile_ms(
            torch, lambda: pruning.site_log_likelihoods(p_four, gp.leaves, freqs, gp.schedule),
            os.path.join("chiprun_out", "profile_fubar_grid.txt"))
    del p_four
    log(f"[fubar] one grid-form pruning of {len(GRID_FP32_POINTS)} points (fp32) profiled: wall "
        f"{prof['wall_ms']:.3f} ms, kernels {prof['device_ms']:.3f} ms in {prof['launches']} "
        f"launches ({len(prof['k1_launch_ms'])} K1, {sum(prof['k1_launch_ms']):.3f} ms), idle "
        f"share {prof['idle_share']:.3f}; top {prof['top'][:3]}")
    res["fold_equal_to_each_point_alone"] = bool(torch.equal(folded, alone))
    res["fold_vs_one_set_max_rel"] = float(((folded - one_set).abs() / one_set.abs()).max())
    res["fold_equal_to_pass"] = bool(torch.equal(folded, sll32[fold]))
    log(f"[fubar] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items())
        + f"; grid passes {[round(t, 3) for t in res['grid_pass_s']]} s; chunks {chunks}")
    res["peak_per_point_gb"] = res["peak_gb"] / max(c["chunk"] for c in chunks)
    log(f"[fubar] bytes per grid point: modelled {chunks[0]['bytes_per_item'] / 1e9:.3f} GB "
        f"(pruning.grid_point_bytes and the propagators), the run's peak over its largest "
        f"chunk {res['peak_per_point_gb']:.3f} GB")
    log(f"[fubar] K1 launches {res['level_products_launches']}; peak {res['peak_gb']:.2f} GB; "
        f"posterior sum {res['posterior_sum']:.12f}; sites at P[beta>alpha] >= 0.9: "
        f"{res['sites_p_pos_ge_0.9']}; planted {[round(x, 4) for x in res['planted_p_pos']]}")
    log(f"[fubar] pass 2 on grid points {GRID_FP32_POINTS}: fp32 Taylor vs fp64 spectral max "
        f"|d| {res['fp32_vs_fp64']:.3e} (bound {GRID_FP32_BOUND}); points {GRID_FOLD_POINTS} "
        f"folded: equal to each alone {res['fold_equal_to_each_point_alone']}, to the run's pass "
        f"{res['fold_equal_to_pass']}, vs the one-set form max rel "
        f"{res['fold_vs_one_set_max_rel']:.3e} (bound {GRID_FOLD_REL_BOUND})")
    check(res["fp32_vs_fp64"] <= GRID_FP32_BOUND, "FUBAR fp32 grid far from fp64")
    check(res["fold_equal_to_each_point_alone"] and res["fold_equal_to_pass"],
          "FUBAR grid points depend on the points beside them")
    check(res["fold_vs_one_set_max_rel"] <= GRID_FOLD_REL_BOUND,
          "FUBAR folded grid far from the one-set pruning")
    check(sum(p >= 0.9 for p in res["planted_p_pos"]) >= 7,
          f"planted codons at P[beta > alpha] >= 0.9: {res['planted_p_pos']}")
    check(res["level_products_launches"] > 0, "FUBAR launched no level_products kernel")
    return res


def phase_bstill(torch, aln, tree_path: str, tmp: str) -> dict:
    """B-STILL on phase 9's alignment cut to BSTILL_CODONS codons through
    ``warmup b-still --grid GRID_POINTS``: seconds, K1 launches; the JSON
    and finite EBFs.  Then K1's node limit: pass 2 again on its first
    FORCED_PATTERNS patterns with the chunk forced to the whole grid, which
    the grid pass must cut (:func:`pruning.max_grid_points`) so that every
    level's launch stays within 65535 node rows, each point equal to the
    run's."""
    import dataclasses

    import numpy as np

    from hyphy_tpu_torch.methods import bstill, common, fubar
    from hyphy_tpu_torch.ops import pruning
    from hyphy_tpu_torch.ops.level_products import _MAX_NODES, level_products

    fasta = _cut_fasta(aln, os.path.join(tmp, "bstill.fasta"), BSTILL_CODONS)
    out_json = os.path.join(tmp, "bstill.BSTILL.json")
    argv = ["warmup", "b-still", "--alignment", fasta, "--tree", tree_path, "--output", out_json,
            "--grid", str(GRID_POINTS)]
    clock, res = _run_cli(torch, argv, [
        (common, "load_codon_data", "load"),
        (common, "fit_gtr", "gtr"),
        (fubar, "grid_pass", "grid_pass"),
        (bstill, "posterior_over_grid", "posterior"),
    ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    with open(out_json) as fh:
        result = json.load(fh)
    table = np.asarray(result["MLE"]["content"]["0"], dtype=np.float64)
    check(table.shape == (BSTILL_CODONS, 14), f"B-STILL table of shape {table.shape}")
    check(bool(np.isfinite(table).all()), "non-finite entries in the B-STILL table")
    posterior = np.asarray(result["posterior"]["0"], dtype=np.float64)
    check(posterior.shape == (BSTILL_CODONS, GRID_POINTS ** 2),
          f"B-STILL posteriors of shape {posterior.shape}")
    res["ebf_max"] = table[:, 9:13].max(axis=0).tolist()
    res["proximal_sites"] = int((table[:, 12] >= 10.0).sum())
    log(f"[bstill] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items())
        + f"; K1 launches {res['level_products_launches']}; peak {res['peak_gb']:.2f} GB; "
        f"EBF maxima {res['ebf_max']}; proximal sites {res['proximal_sites']}")
    check(res["level_products_launches"] > 0, "B-STILL launched no level_products kernel")

    (gp, grid_t, times), sll = clock.last["grid_pass"]
    cut = dataclasses.replace(gp, leaves=gp.leaves[:, :FORCED_PATTERNS].contiguous())
    n_points = grid_t.shape[0]
    rows = max(pruning._launch_rows(plan) for plan in gp.schedule.plans)
    before = level_products.launches
    with _recorded_solves([]) as blocks:
        t0 = time.perf_counter()
        forced = fubar.grid_pass(cut, grid_t, times, chunk=n_points)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    check(len(blocks) == 1, f"phase 13's grid pass ran in {len(blocks)} blocks on one card")
    chunk, n_calls = blocks[0]["chunk"], blocks[0]["calls"]
    run = sll[:, :FORCED_PATTERNS]
    finite = torch.isfinite(run)      # -inf: patterns a grid point cannot produce
    res["forced_chunk"] = {
        "points": n_points, "forced": n_points, "chunk": chunk, "calls": n_calls,
        "widest_rows": rows, "rows_per_launch": chunk * rows, "seconds": seconds,
        "launches": level_products.launches - before,
        "max_rel_vs_run": float(((forced - run).abs() / run.abs())[finite].max()),
        "same_impossible": bool(torch.equal(torch.isfinite(forced), finite)),
        "equal_to_run": bool(torch.equal(forced, run))}
    fc = res["forced_chunk"]
    log(f"[bstill] pass 2 on {FORCED_PATTERNS} patterns, chunk forced to {n_points} points: "
        f"cut to {chunk} ({n_points * rows} node rows uncut, {fc['rows_per_launch']} per launch, "
        f"limit {_MAX_NODES}), {n_calls} calls, {fc['launches']} K1 launches, "
        f"{fc['seconds']:.3f} s; vs the run's pass max rel {fc['max_rel_vs_run']:.3e}, equal "
        f"{fc['equal_to_run']}")
    check(n_points * rows > _MAX_NODES, "the forced chunk did not pass K1's node limit")
    check(chunk * rows <= _MAX_NODES and n_calls >= 2, f"grid chunk {chunk} not cut")
    check(fc["launches"] == n_calls * len(gp.schedule.plans),
          f"{fc['launches']} K1 launches for {n_calls} calls")
    check(fc["max_rel_vs_run"] <= GRID_FOLD_REL_BOUND and fc["same_impossible"],
          "the forced-chunk pass differs from the run's")
    return res


def _clade_members(tree, node):
    out, stack = [], [node]
    while stack:
        nd = stack.pop()
        out.append(nd)
        stack.extend(tree.children[nd])
    return out


def _contrast_clades(tree, sizes=CONTRAST_CLADES):
    """Disjoint clades near ``sizes`` leaves: for each in turn, the
    non-root node whose leaf count is nearest (lowest id on ties), outside
    and not above the clades taken.  Returns their node lists."""
    leaves = {nd: sum(1 for m in _clade_members(tree, nd) if tree.is_leaf(m))
              for nd in range(tree.n_nodes) if nd != tree.root}
    taken, clades = set(), []
    for size in sizes:
        free = [nd for nd in leaves if not set(_clade_members(tree, nd)) & taken
                and not any(nd in _clade_members(tree, c[0]) for c in clades)]
        best = min(free, key=lambda nd: (abs(leaves[nd] - size), nd))
        clades.append(_clade_members(tree, best))
        taken |= set(clades[-1])
    return clades


def _labelled_newick(tree, lengths, labels) -> str:
    """``tree`` as Newick with ``lengths`` and a ``{label}`` on each node
    that ``labels`` maps."""
    def fmt(nd):
        base = tree.names[nd] if tree.is_leaf(nd) else (
            "(" + ",".join(fmt(c) for c in tree.children[nd]) + ")" + tree.names[nd])
        if nd in labels:
            base += "{" + labels[nd] + "}"
        return base + (f":{lengths[nd]:.6f}" if nd != tree.root else "")

    return fmt(tree.root)


def _contrast_alignment(tmp: str, kappa: float = 2.5, omega: float = 0.3):
    """The contrast alignment of phases 14-15: disjoint clades of
    ``random_tree_newick(N_TAXA, SEED)`` near CONTRAST_CLADES leaves (for
    each in turn, the non-root node whose leaf count is nearest, lowest id
    on ties, outside and not above the clades taken) labelled
    CONTRAST_LABELS on every branch, stem included; codons drawn along it
    with ``utils/simulate.py::simulate_states`` under MG94-style
    propagators (``synth._mg94_generator``'s unit-rate generator at omega
    0.3) everywhere, except PLANTED_OMEGA at the same synonymous rate on the
    first label's branches at PLANTED_SITES.  Returns (alignment, FASTA,
    newick file)."""
    import numpy as np
    import scipy.linalg as sla

    from hyphy_tpu_torch.data.alignment import Alignment
    from hyphy_tpu_torch.data.genetic_code import GeneticCode
    from hyphy_tpu_torch.tree.topology import Tree
    from hyphy_tpu_torch.utils import synth
    from hyphy_tpu_torch.utils.simulate import simulate_states, states_to_alignment

    t0 = time.perf_counter()
    gc = GeneticCode("Universal")
    tree = Tree.from_newick(synth.random_tree_newick(N_TAXA, seed=SEED))
    lengths = np.maximum(np.asarray(tree.input_lengths[:-1]), 1e-6)
    clades = _contrast_clades(tree)
    labels = {nd: lbl for lbl, clade in zip(CONTRAST_LABELS, clades) for nd in clade}
    pi = np.full(gc.n_states, 1.0 / gc.n_states)
    slow = synth._mg94_generator(gc, kappa, omega)
    # PLANTED_OMEGA at the same synonymous rate: the non-synonymous entries
    # of the unit-rate omega generator scaled by PLANTED_OMEGA / omega
    amino = np.array(list(gc.translation))[np.asarray(gc.sense_codons)]
    fast = np.where(amino[:, None] != amino[None, :], slow * (PLANTED_OMEGA / omega), slow)
    np.fill_diagonal(fast, 0.0)
    fast -= np.diag(fast.sum(axis=1))
    base = np.stack([sla.expm(slow * t) for t in lengths])
    selected = base.copy()
    for nd in clades[0]:
        selected[nd] = sla.expm(fast * lengths[nd])
    rng = np.random.default_rng(SEED)
    cols = np.setdiff1d(np.arange(N_CODONS), PLANTED_SITES)
    states = np.zeros((tree.n_nodes, N_CODONS), dtype=np.int32)
    states[:, cols] = simulate_states(tree, base, pi, len(cols), rng)
    states[:, PLANTED_SITES] = simulate_states(tree, selected, pi, len(PLANTED_SITES), rng)
    names, seqs = states_to_alignment(states, tree, "codon", gc)
    fasta = os.path.join(tmp, "contrast.fasta")
    _write_fasta(fasta, names, seqs)
    tree_path = os.path.join(tmp, "contrast.nwk")
    with open(tree_path, "w") as fh:
        fh.write(_labelled_newick(tree, lengths, labels))
    log(f"[contrast] alignment of {N_TAXA} taxa x {N_CODONS} codons, clades of "
        f"{[sum(tree.is_leaf(m) for m in c) for c in clades]} leaves labelled "
        f"{CONTRAST_LABELS}, omega {PLANTED_OMEGA} on {CONTRAST_LABELS[0]} at "
        f"{PLANTED_SITES}: {time.perf_counter() - t0:.2f} s on the host")
    return Alignment(names, seqs), fasta, tree_path


def _contrast_table(result, n_codons):
    import numpy as np

    headers = [h[0] for h in result["MLE"]["headers"]]
    table = np.asarray(result["MLE"]["content"]["0"], dtype=np.float64)
    check(table.shape == (n_codons, len(headers)), f"table of shape {table.shape}")
    check(bool(np.isfinite(table).all()), "non-finite entries in the table")
    p = table[:, headers.index("P-value (overall)")]
    check(bool(((p >= 0) & (p <= 1)).all()), "p-values outside [0, 1]")
    return headers, table, p


def phase_contrast_fel(torch, aln, tree_path: str, tmp: str) -> dict:
    """contrast-FEL (G = 3) on the contrast alignment cut to CFEL_CODONS
    codons, at 1000 taxa, through ``warmup contrast-fel --branch-set FG
    --branch-set REF``: seconds per stage, ms per batched
    site evaluation, one profiled, peak memory, K1 launches; the planted
    codons at p <= 0.1; the per-site lnL of 64 sites card vs host (fp64
    Taylor) and fp32 vs fp64 on every pattern; the substitution counts card
    vs host."""
    import numpy as np

    from hyphy_tpu_torch.methods import common, contrast_fel, fel

    fasta = _cut_fasta(aln, os.path.join(tmp, "contrast_cfel.fasta"), CFEL_CODONS)
    out_json = os.path.join(tmp, "contrast.CFEL.json")
    argv = ["warmup", "contrast-fel", "--alignment", fasta, "--tree", tree_path,
            "--output", out_json]
    for lbl in CONTRAST_LABELS:
        argv += ["--branch-set", lbl]
    clock, res = _run_cli(torch, argv, [
        (contrast_fel, "load_multigroup", "load"),
        (common, "fit_gtr", "gtr"),
        (common, "fit_partitioned_mg94", "mg94"),
        (contrast_fel, "fit_sites", "per_site"),
        (contrast_fel, "substitution_counts", "substitution_counts"),
        (contrast_fel, "grid_best_starts", "grid"),
        (contrast_fel, "vmapped_nelder_mead", "nelder_mead"),
    ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    res["calls"] = dict(clock.calls)
    res["site_eval_ms"] = _eval_stats(clock.eval_ms)
    with open(out_json) as fh:
        result = json.load(fh)
    headers, table, p = _contrast_table(result, CFEL_CODONS)
    check(headers[1:4] == [f"beta ({g})" for g in CONTRAST_LABELS + ["background"]],
          f"contrast-FEL headers {headers}")
    planted = [s for s in PLANTED_SITES if s < CFEL_CODONS]
    res["table"] = {"sites_p_le_0.1": int((p <= 0.1).sum()), "planted": planted,
                    "planted_p": p[planted].tolist()}
    res["profile_eval"] = prof = _profile_last_fit(torch, clock, "contrast_fel_site_eval")

    (data, mgp, _), _ = clock.last["per_site"]
    groups = np.asarray(data.branch_groups)
    n = min(SITE_PARITY_N, data.codon_filter.n_patterns)
    idx = torch.arange(n, device=DEVICE)
    f64 = dict(dtype=torch.float64, device=DEVICE)
    a = torch.linspace(0.2, 2.0, n, **f64)
    betas = torch.stack([torch.linspace(0.1, 8.0, n, **f64), torch.full((n,), 0.3, **f64),
                         torch.linspace(2.0, 0.05, n, **f64)], dim=1)
    host_fit = _host_fit(mgp, data)
    with torch.no_grad():
        card64 = fel.site_log_likelihood(data, mgp, torch.float64, False, groups=groups)
        host64 = fel.site_log_likelihood(data, host_fit, torch.float64, False, groups=groups)
        res["site_fp64_card_vs_host"] = float(
            (card64(idx, a, betas).cpu() - host64(idx.cpu(), a.cpu(), betas.cpu())).abs().max())
        card32 = fel.site_log_likelihood(data, mgp, torch.float32, False, groups=groups)
        rows = torch.arange(data.codon_filter.n_patterns, device=DEVICE)
        a_all = torch.ones(rows.shape[0], **f64)
        b_all = torch.tensor([[2.0, 0.3, 0.5]], **f64).expand(rows.shape[0], -1)
        res["site_fp32_vs_fp64"] = float(
            (card32(rows, a_all, b_all).double() - card64(rows, a_all, b_all)).abs().max())
    card_counts = contrast_fel.substitution_counts(data, mgp, 3)
    host_counts = contrast_fel.substitution_counts(data, host_fit, 3)
    res["counts_card_vs_host_equal"] = bool(np.array_equal(card_counts, host_counts))
    res["counts_per_set"] = card_counts.sum(axis=1).tolist()
    log(f"[contrast-fel] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items()) + f"; calls {res['calls']}")
    log(f"[contrast-fel] K1 launches {res['level_products_launches']}; peak {res['peak_gb']:.2f} GB; "
        f"batched site evaluations "
        f"{ {k: round(v, 3) for k, v in res['site_eval_ms'].items()} } ms; one profiled "
        f"({prof['sites']} sites): wall {prof['wall_ms']:.3f} ms, kernels {prof['device_ms']:.3f} "
        f"ms in {prof['launches']} launches, idle share {prof['idle_share']:.3f}")
    log(f"[contrast-fel] table {res['table']}; per-site lnL (G = 3) fp64 Taylor card vs host on "
        f"{n} sites {res['site_fp64_card_vs_host']:.3e} (bound {SITE_HOST_BOUND}), fp32 vs fp64 "
        f"on {rows.shape[0]} patterns {res['site_fp32_vs_fp64']:.3e} (bound {SITE_FP32_BOUND}); "
        f"substitution counts card = host {res['counts_card_vs_host_equal']}, per set "
        f"{res['counts_per_set']}")
    # 7 of the 9 planted codons at full width: all but two of those kept
    check(sum(x <= 0.1 for x in res["table"]["planted_p"]) >= len(planted) - 2,
          f"planted codons at p <= 0.1: {res['table']['planted_p']}")
    check(res["site_fp64_card_vs_host"] <= SITE_HOST_BOUND, "contrast-FEL site lnL: card vs host")
    check(res["site_fp32_vs_fp64"] <= SITE_FP32_BOUND, "contrast-FEL fp32 site lnL far from fp64")
    check(res["counts_card_vs_host_equal"], "contrast-FEL substitution counts: card vs host")
    check(res["level_products_launches"] > 0, "contrast-FEL launched no level_products kernel")
    return res


def phase_contrast_meme(torch, aln, tree_path: str, tmp: str) -> dict:
    """contrast-MEME on the contrast alignment cut to CMEME_CODONS codons
    through ``warmup contrast-meme --permutations CMEME_PERMUTATIONS``:
    seconds per stage (alternative, nulls, permutations), jobs and chunks,
    K1 launches; the mixture site lnL of 64 sites card vs host (fp64
    Taylor); permutation p-values in multiples of 1/(N+1)."""
    import numpy as np

    from hyphy_tpu_torch.methods import common, contrast_meme

    fasta = _cut_fasta(aln, os.path.join(tmp, "cmeme.fasta"), CMEME_CODONS)
    out_json = os.path.join(tmp, "contrast.CMEME.json")
    argv = ["warmup", "contrast-meme", "--alignment", fasta, "--tree", tree_path,
            "--output", out_json, "--permutations", str(CMEME_PERMUTATIONS)]
    for lbl in CONTRAST_LABELS:
        argv += ["--branch-set", lbl]
    with _recorded_solves([]) as solves:
        clock, res = _run_cli(torch, argv, [
            (contrast_meme, "load_multigroup", "load"),
            (common, "fit_gtr", "gtr"),
            (common, "fit_partitioned_mg94", "mg94"),
            (contrast_meme, "alternative_stage", "alternative"),
            (contrast_meme, "null_stage", "null"),
            (contrast_meme, "pairwise_stage", "pairwise"),
            (contrast_meme, "permutation_stage", "permutations"),
            (contrast_meme, "substitution_counts", "substitution_counts"),
        ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    res["calls"] = dict(clock.calls)
    # the permutation stage calls the alternative stage too: its seconds
    # per call, the sites' first
    res["alternative_each_s"] = clock.each["alternative"]
    res["solves"] = solves
    with open(out_json) as fh:
        result = json.load(fh)
    headers, table, p = _contrast_table(result, CMEME_CODONS)
    perm = table[:, headers.index("Permutation p-value")]
    tested = perm >= 0
    step = 1.0 / (CMEME_PERMUTATIONS + 1)
    res["permutation_sites"] = int(tested.sum())
    res["permutation_p"] = perm[tested].tolist()
    planted = [s for s in PLANTED_SITES if s < CMEME_CODONS]
    res["table"] = {"sites_p_le_0.1": int((p <= 0.1).sum()), "planted_p": p[planted].tolist()}
    check(bool(np.allclose(np.round(perm[tested] / step) * step, perm[tested], rtol=0,
                           atol=1e-12) and (perm[tested] >= step - 1e-12).all()),
          f"permutation p-values not multiples of 1/{CMEME_PERMUTATIONS + 1}")
    check(bool((perm[~tested] == -1).all()), "permutation p-values of unscreened sites")

    model, _, _, idx_sites = clock.first["alternative"]
    with torch.no_grad():
        point = {key: v[0].expand(idx_sites.shape[0]) for key, v in
                 contrast_meme._start_grid(model.n_groups, model.srv, DEVICE).items()}
        res["profile_eval"] = prof = profile_ms(
            torch, lambda: model.alternative(idx_sites, point),
            os.path.join("chiprun_out", "profile_contrast_meme_eval.txt"))
    prof["sites"] = int(idx_sites.shape[0])
    log(f"[contrast-meme] one mixture evaluation ({prof['sites']} sites, 6 families, fp32 "
        f"Taylor) profiled: wall {prof['wall_ms']:.3f} ms, kernels {prof['device_ms']:.3f} ms in "
        f"{prof['launches']} launches, idle share {prof['idle_share']:.3f}")
    data, mgp = clock.last["substitution_counts"][0][:2]
    n = min(SITE_PARITY_N, data.codon_filter.n_patterns)
    f64 = dict(dtype=torch.float64, device=DEVICE)
    sites = torch.arange(n, device=DEVICE)
    a = torch.linspace(0.2, 2.0, n, **f64)
    b1 = torch.stack([torch.linspace(0.0, 1.0, n, **f64)] * 3, dim=1)
    b2 = torch.stack([torch.linspace(8.0, 1.0, n, **f64), torch.full((n,), 0.5, **f64),
                      torch.full((n,), 2.0, **f64)], dim=1)
    prop = torch.stack([torch.linspace(0.1, 0.9, n, **f64)] * 3, dim=1)
    # a permuted branch-to-set map per site, as the permutation jobs carry
    rng = np.random.default_rng(1)
    groups = torch.as_tensor(np.stack([rng.permutation(data.branch_groups) for _ in range(n)]),
                             device=DEVICE)
    with torch.no_grad():
        card = contrast_meme.set_mixture(data, mgp, torch.float64, False)
        host = contrast_meme.set_mixture(data, _host_fit(mgp, data), torch.float64, False)
        res["mixture_fp64_card_vs_host"] = float(
            (card.loglik(sites, a, b1, b2, prop, groups).cpu()
             - host.loglik(sites.cpu(), a.cpu(), b1.cpu(), b2.cpu(), prop.cpu(), groups.cpu()))
            .abs().max())
    log(f"[contrast-meme] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items()) + f"; calls {res['calls']}")
    log(f"[contrast-meme] alternative per call (sites, then permutation jobs) "
        f"{[round(t, 3) for t in res['alternative_each_s']]} s; solves (items, chunk) "
        f"{[(x['items'], x['chunk']) for x in solves]}; "
        f"K1 launches {res['level_products_launches']}; peak {res['peak_gb']:.2f} GB; "
        f"table {res['table']}; {res['permutation_sites']} sites permuted, p "
        f"{res['permutation_p']}")
    log(f"[contrast-meme] mixture site lnL (6 families, per-item set maps), fp64 Taylor, card vs "
        f"host on {n} sites: {res['mixture_fp64_card_vs_host']:.3e} (bound {SITE_HOST_BOUND})")
    check(res["mixture_fp64_card_vs_host"] <= SITE_HOST_BOUND,
          "contrast-MEME mixture site lnL: card vs host")
    check(res["level_products_launches"] > 0, "contrast-MEME launched no level_products kernel")
    return res


def phase_meme_resample(torch, aln, tree_path: str, tmp: str) -> dict:
    """``warmup meme --resample MEME_RESAMPLE`` on phase 9's alignment cut
    to RESAMPLE_CODONS codons, with the fused Nelder-Mead probes: the
    simulation's and the refits' seconds; p-values in multiples of 1/(N+1);
    the card's fp64 family propagators of RESAMPLE_CHECK_SITES sites against
    ``scipy.linalg.expm`` on RESAMPLE_CHECK_BRANCHES branches."""
    import numpy as np
    import scipy.linalg as sla

    from hyphy_tpu_torch.methods import common, meme
    from hyphy_tpu_torch.utils import simulate as sim_mod

    fasta = _cut_fasta(aln, os.path.join(tmp, "resample.fasta"), RESAMPLE_CODONS)
    out_json = os.path.join(tmp, "resample.MEME.json")
    argv = ["warmup", "meme", "--alignment", fasta, "--tree", tree_path, "--output", out_json,
            "--resample", str(MEME_RESAMPLE)]
    drawn = []
    original_draw = sim_mod.simulate_states

    def recording(tree, p, root_freqs, n_reps, rng):
        if len(drawn) < RESAMPLE_CHECK_SITES:
            drawn.append(np.array(p))
        return original_draw(tree, p, root_freqs, n_reps, rng)

    sim_mod.simulate_states = recording
    os.environ["HYPHY_TPU_NM_FUSED"] = "1"
    try:
        clock, res = _run_cli(torch, argv, [
            (common, "load_codon_data_multi", "load"),
            (common, "fit_gtr_multi", "gtr"),
            (common, "fit_partitioned_mg94_multi", "mg94"),
            (meme, "site_pipeline", "pipeline"),
            (meme, "branch_ebfs", "ebf"),
            (meme, "simulate_null_states", "simulation"),
            (meme, "bootstrap_lrts", "bootstrap"),
            (meme, "_alternative_stage", "alternative"),
        ])
    finally:
        del os.environ["HYPHY_TPU_NM_FUSED"]
        sim_mod.simulate_states = original_draw
    res["command"] = ("HYPHY_TPU_NM_FUSED=1 " + " ".join(
        ["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv]))
    res["stages_s"] = dict(clock.seconds)
    res["refit_s"] = res["stages_s"]["bootstrap"] - res["stages_s"]["simulation"]
    # the bootstrap's alternative: one batched mixture evaluation of its items
    sites, _, idx, starts = clock.last["alternative"][0]
    with torch.no_grad():
        res["profile_eval"] = prof = profile_ms(
            torch, lambda: sites.loglik(idx, starts),
            os.path.join("chiprun_out", "profile_resample_eval.txt"))
    prof["items"] = int(idx.shape[0])
    log(f"[resample] one bootstrap mixture evaluation ({prof['items']} items) profiled: wall "
        f"{prof['wall_ms']:.3f} ms, kernels {prof['device_ms']:.3f} ms in {prof['launches']} "
        f"launches, idle share {prof['idle_share']:.3f}")
    with open(out_json) as fh:
        result = json.load(fh)
    headers = [h[0] for h in result["MLE"]["headers"]]
    table = np.asarray(result["MLE"]["content"]["0"], dtype=np.float64)
    check(table.shape == (RESAMPLE_CODONS, len(headers)) and bool(np.isfinite(table).all()),
          f"MEME --resample table of shape {table.shape}")
    p = table[:, headers.index("p-value")]
    step = 1.0 / (MEME_RESAMPLE + 1)
    check(bool(np.allclose(np.round(p / step) * step, p, rtol=0, atol=1e-12)
               and (p >= step - 1e-12).all() and (p <= 1.0).all()),
          f"bootstrap p-values not multiples of 1/{MEME_RESAMPLE + 1} in [1/{MEME_RESAMPLE + 1}, 1]")
    res["p_le_0.25"] = int((p <= 0.25).sum())

    # the card's fp64 propagators of the first sites against scipy's expm
    data, mgp, null, k = clock.last["simulation"][0][:4]
    filt = data.codon_filter
    sites = np.nonzero(~filt.constant_pattern_mask())[0][:RESAMPLE_CHECK_SITES]
    tested = data.tested_branches
    branches = np.nonzero(tested)[0][:RESAMPLE_CHECK_BRANCHES]
    with torch.no_grad():
        q_syn, q_non = (q.double().cpu().numpy()
                        for q in mgp.model.combined_basis_matrices(mgp.params))
    worst = 0.0
    for s, p_card in zip(sites, drawn):
        a = null["alpha"][s]
        w = meme._stick_weights(torch.as_tensor(
            [null[f"w_{i}"][s] for i in range(1, k)], dtype=torch.float64)).numpy()
        betas = [null[f"omega_{i}"][s] * a for i in range(1, k)] + [a]
        fams = []
        for beta in betas:
            q = a * q_syn + beta * q_non
            fams.append(q - np.diag(q.sum(axis=1)))
        for b in branches:
            want = sum(w[c] * sla.expm(fams[c] * mgp.alphas[b]) for c in range(k))
            worst = max(worst, float(np.abs(p_card[b] - want).max()))
    res["propagators_vs_scipy"] = worst
    log(f"[resample] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items())
        + f"; refits {res['refit_s']:.3f} s; K1 launches {res['level_products_launches']}; peak "
        f"{res['peak_gb']:.2f} GB; sites at p <= 0.25: {res['p_le_0.25']}")
    log(f"[resample] fp64 family propagators of sites {sites.tolist()} on branches "
        f"{branches.tolist()}, card vs scipy.linalg.expm: max |d| {worst:.3e} "
        f"(bound {RESAMPLE_EXPM_BOUND})")
    check(len(drawn) == len(sites) and worst <= RESAMPLE_EXPM_BOUND,
          "MEME --resample propagators far from scipy's expm")
    check(res["level_products_launches"] > 0, "MEME --resample launched no level_products kernel")
    return res


def phase_prime(torch, aln, tree_path: str, tmp: str) -> dict:
    """PRIME on phase 9's alignment cut to PRIME_CODONS codons, at 1000
    taxa, through ``warmup prime``:
    seconds per stage, ms per batched site evaluation, K1 launches, peak
    memory; the per-site objective card vs host (fp64 Taylor) on
    SITE_PARITY_N sites at PRIME_POINTS and fp32 vs fp64 on every pattern;
    the JSON."""
    import numpy as np

    from hyphy_tpu_torch import cli
    from hyphy_tpu_torch.methods import common, prime

    fasta = _cut_fasta(aln, os.path.join(tmp, "prime.fasta"), PRIME_CODONS)
    out_json = os.path.join(tmp, "sim.PRIME.json")
    argv = ["warmup", "prime", "--alignment", fasta, "--tree", tree_path, "--output", out_json]
    clock, res = _run_cli(torch, argv, [
        (common, "load_codon_data", "load"),
        (common, "fit_gtr", "gtr"),
        (common, "fit_partitioned_mg94", "mg94"),
        (prime, "site_log_likelihood", "objective"),
        (prime, "grid_best_starts", "grid"),
        (prime, "vmapped_nelder_mead", "nelder_mead"),
        (cli, "write_json", "json"),
    ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    res["fits_s"] = {"full": clock.each["nelder_mead"][0], "nulls": clock.each["nelder_mead"][1:]}
    res["site_eval_ms"] = _eval_stats(clock.eval_ms)
    with open(out_json) as fh:
        result = json.load(fh)
    table = np.asarray(result["MLE"]["content"]["0"], dtype=np.float64)
    check(table.shape == (PRIME_CODONS, 18), f"PRIME table of shape {table.shape}")
    check(bool(np.isfinite(table).all()), "non-finite entries in the PRIME table")
    pvals = table[:, [5 + 3 * k for k in range(5)]]
    check(bool(((pvals >= 0) & (pvals <= 1)).all()), "PRIME p-values outside [0, 1]")
    res["table"] = {"min_p_per_property": pvals.min(axis=0).tolist()}

    data, mgp, dists = clock.first["objective"][:3]
    n = min(SITE_PARITY_N, data.codon_filter.n_patterns)
    host_fit = _host_fit(mgp, data)
    card64 = prime.site_log_likelihood(data, mgp, dists, torch.float64, False)
    host64 = prime.site_log_likelihood(data, host_fit, dists.cpu(), torch.float64, False)
    card32 = prime.site_log_likelihood(data, mgp, dists, torch.float32, False)
    f64 = dict(dtype=torch.float64, device=DEVICE)

    def point(rows, alpha, beta, lam0, lam):
        p = {"alpha": torch.full((rows,), alpha, **f64), "beta": torch.full((rows,), beta, **f64)}
        p.update({f"lambda_{k}": torch.full((rows,), lam0 if k == 0 else lam, **f64)
                  for k in range(5)})
        return p

    ones = torch.ones(5, **f64)
    res["site_fp64_card_vs_host"] = {}
    with torch.no_grad():
        for pt in PRIME_POINTS:
            p = point(n, *pt)
            card = card64(torch.arange(n, device=DEVICE), p, ones).cpu()
            host = host64(torch.arange(n), {k: v.cpu() for k, v in p.items()}, ones.cpu())
            res["site_fp64_card_vs_host"][str(pt)] = float((card - host).abs().max())
        rows = data.codon_filter.n_patterns
        idx = torch.arange(rows, device=DEVICE)
        p = point(rows, *PRIME_POINTS[1])
        res["site_fp32_vs_fp64"] = float((card32(idx, p, ones).double()
                                          - card64(idx, p, ones)).abs().max())
        p10 = point(rows, *PRIME_POINTS[2])
        res["site_eval_fp32_ms_lambda10"] = _event_and_wall_ms(
            torch, lambda: card32(idx, p10, ones), 3)
    log(f"[prime] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items())
        + f"; full fit {res['fits_s']['full']:.3f} s, nulls "
        f"{[round(x, 3) for x in res['fits_s']['nulls']]} s")
    log(f"[prime] K1 launches {res['level_products_launches']}; peak {res['peak_gb']:.2f} GB; "
        f"batched site evaluations {_rounded(res['site_eval_ms'])} ms; at |lambda| = 10 "
        f"(fp32, every pattern) {_rounded(res['site_eval_fp32_ms_lambda10'])}")
    log(f"[prime] per-site objective fp64 Taylor card vs host on {n} sites "
        f"{ {k: f'{v:.3e}' for k, v in res['site_fp64_card_vs_host'].items()} } (bound "
        f"{SITE_HOST_BOUND}); fp32 vs fp64 on {rows} patterns {res['site_fp32_vs_fp64']:.3e} "
        f"(bound {SITE_FP32_BOUND}); min p per property {res['table']['min_p_per_property']}")
    for pt, d in res["site_fp64_card_vs_host"].items():
        check(d <= SITE_HOST_BOUND, f"PRIME site lnL card vs host at {pt}: {d}")
    check(res["site_fp32_vs_fp64"] <= SITE_FP32_BOUND, "PRIME fp32 site lnL far from fp64")
    check(res["level_products_launches"] > 0, "PRIME launched no level_products kernel")
    return res


def _rounded(d: dict) -> dict:
    return {k: round(v, 3) if isinstance(v, float) else v for k, v in d.items()}


def _bsrel_copy(torch, engine, data, device, dtype, patterns=None, basis=None):
    """A BSRELEngine over the run engine's model, tree and (the first
    ``patterns``) patterns on ``device`` in ``dtype``, on the Taylor route;
    ``basis``: None, or "Double+Triple" for the multi-hit bases."""
    from hyphy_tpu_torch.models.bsrel import BSRELEngine
    from hyphy_tpu_torch.models.codon import MG94Base
    from hyphy_tpu_torch.ops import pruning

    model = engine.model
    mg94 = MG94Base(model.gc, model.corner_freqs, model.frequencies.cpu().numpy(), device=device)
    basis_fn = None
    if basis:
        def basis_fn(params):
            q1s, q1n = mg94.basis_matrices(params)
            q2s, q2n = mg94.multihit_basis_matrices(params, 2)
            q3s, q3n = mg94.multihit_basis_matrices(params, 3)
            return (q1s + params["delta"] * q2s + params["psi"] * q3s,
                    q1n + params["delta"] * q2n + params["psi"] * q3n)
    leaves = engine.leaf_partials.cpu().numpy()
    weights = engine.pattern_weights.cpu().numpy()
    if patterns is not None:
        leaves, weights = leaves[:, :patterns], weights[:patterns]
    saved = os.environ.get("HYPHY_TPU_PRECISION")
    os.environ["HYPHY_TPU_PRECISION"] = str(dtype).split(".")[-1]
    try:
        out = BSRELEngine(mg94, pruning.build_pruning_data(data.tree, device), leaves, weights,
                          engine.group_of_branch.cpu().numpy(), engine.srv_classes,
                          basis_fn=basis_fn)
    finally:
        if saved is None:
            del os.environ["HYPHY_TPU_PRECISION"]
        else:
            os.environ["HYPHY_TPU_PRECISION"] = saved
    out.spectral = False
    return out


def phase_busted(torch, fasta: str, tree_path: str, tmp: str) -> dict:
    """BUSTED at full width on phase 9's alignment through ``warmup busted``
    (SRV 3 x 3, 2 starting points): seconds per stage, ms per value and
    gradient (also on both forms of the fp32 Taylor route), K1 launches per
    evaluation, peak memory; card vs host, fp32 vs fp64, the folded
    classes, the options' objectives; the JSON."""
    import numpy as np

    from hyphy_tpu_torch import cli
    from hyphy_tpu_torch.methods import busted, common
    from hyphy_tpu_torch.models import bsrel
    from hyphy_tpu_torch.ops import hmm, pruning
    from hyphy_tpu_torch.ops.level_products import level_products

    out_json = os.path.join(tmp, "sim.BUSTED.json")
    argv = ["warmup", "busted", "--alignment", fasta, "--tree", tree_path, "--output", out_json]
    clock, res = _run_cli(torch, argv, [
        (common, "load_codon_data", "load"),
        (common, "fit_gtr", "gtr"),
        (common, "fit_partitioned_mg94", "mg94"),
        (busted, "BSRELEngine", "engine"),
        (busted, "fit_unconstrained", "unconstrained"),
        (busted, "fit_constrained", "constrained"),
        (busted, "maximize", "maximize"),
        (cli, "write_json", "json"),
    ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    res["maximize_s"] = clock.each["maximize"]
    with open(out_json) as fh:
        result = json.load(fh)
    check(all(k in result for k in ("test results", "Evidence Ratios", "Site Log Likelihood",
                                    "fits")), f"BUSTED JSON keys {sorted(result)}")
    tr = result["test results"]
    er = np.asarray(result["Evidence Ratios"]["optimized null"][0])
    res["test"] = {"LRT": tr["LRT"], "p": tr["p-value"]}
    check(tr["LRT"] >= 0 and 0 <= tr["p-value"] <= 1, f"BUSTED test {tr}")
    check(er.shape == (N_CODONS,) and bool(np.isfinite(er).all()), "BUSTED evidence ratios")

    data = clock.last["load"][1]
    engine = clock.last["engine"][1]
    loglik, _, params = clock.last["constrained"][0][:3]
    n_levels = len(engine.pdata.plans)

    def value_and_grad():
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        v = loglik(p)
        v.backward()
        return v

    before = level_products.launches
    with torch.no_grad():
        loglik(params)
    res["k1_launches_per_value"] = level_products.launches - before
    res["levels"] = n_levels
    res["value_grad_ms"] = _eval_stats(wall_ms(torch, value_and_grad, 3))
    with torch.no_grad():
        res["value_ms"] = _eval_stats(wall_ms(torch, lambda: loglik(params), 3))
        res["profile_value"] = prof = profile_ms(
            torch, lambda: loglik(params), os.path.join("chiprun_out", "profile_busted_value.txt"))
    torch.cuda.reset_peak_memory_stats()
    value_and_grad()
    res["value_grad_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["routes"] = _route_ms(torch, engine, loglik, params)

    def unpack_at(eng, p):
        om = torch.stack([p[f"test_omega_{i}"] for i in (1, 2, 3)])
        w = bsrel.stick_breaking_weights(torch.stack([p["test_w_1"], p["test_w_2"]]))
        rates, wsrv = bsrel.srv_distribution(p, eng.srv_classes)
        return om[None], w[None], rates, wsrv

    n = min(SITE_PARITY_N, data.codon_filter.n_patterns)
    card = _bsrel_copy(torch, engine, data, DEVICE, torch.float64, n)
    host = _bsrel_copy(torch, engine, data, "cpu", torch.float64, n)
    host_params = {k: v.detach().cpu() for k, v in params.items()}
    point = dict(params, srv_lambda=torch.tensor(0.2, dtype=torch.float64, device=DEVICE),
                 delta=torch.tensor(0.1, dtype=torch.float64, device=DEVICE),
                 psi=torch.tensor(0.05, dtype=torch.float64, device=DEVICE))
    host_point = {k: v.detach().cpu() for k, v in point.items()}

    def rel(a, b):
        return float(((a.cpu() - b) / b.abs()).abs().max())

    with torch.no_grad():
        res["site_fp64_card_vs_host_rel"] = rel(
            card.site_log_likelihoods(params, *_args(unpack_at(card, params), params)),
            host.site_log_likelihoods(host_params, *_args(unpack_at(host, host_params),
                                                          host_params)))
        # the options' objectives at one point: HMM forward lnL, branch-site
        # SRV site lnLs, the Double+Triple bases
        options = {}
        om, w, rates, wsrv = unpack_at(card, point)
        hom, hw, hrates, hwsrv = unpack_at(host, host_point)
        dup = np.arange(n, dtype=np.int32)
        c_sll = card.class_site_log_likelihoods(point, om, w, point["t"], rates)
        h_sll = host.class_site_log_likelihoods(host_point, hom, hw, host_point["t"], hrates)
        options["srv_hmm"] = rel(
            hmm.forward_log_likelihood(c_sll, dup, hmm.uniform_switching_matrix(3, 0.2), wsrv)[None],
            hmm.forward_log_likelihood(h_sll, dup, hmm.uniform_switching_matrix(3, 0.2), hwsrv)[None])
        options["srv_branchsite"] = rel(
            card.branchsite_srv_site_log_likelihoods(point, om, w, point["t"], rates, wsrv),
            host.branchsite_srv_site_log_likelihoods(host_point, hom, hw, host_point["t"], hrates,
                                                     hwsrv))
        card_mh = _bsrel_copy(torch, engine, data, DEVICE, torch.float64, n, "Double+Triple")
        host_mh = _bsrel_copy(torch, engine, data, "cpu", torch.float64, n, "Double+Triple")
        options["multiple_hits"] = rel(
            card_mh.site_log_likelihoods(point, om, w, point["t"], rates, wsrv),
            host_mh.site_log_likelihoods(host_point, hom, hw, host_point["t"], hrates, hwsrv))
        res["options_card_vs_host_rel"] = options
        # the fp64 spectral route card vs host: at the fitted point, and at a
        # synonymous-rate class of weight 1e-12 at time 1e16 (the regime of
        # the zero modes' round-off, ROADMAP 3.15)
        card.spectral = host.spectral = True
        spectral = {}
        for name, (c_rates, c_w) in (("fitted", unpack_at(card, params)[2:]),
                                     ("time_1e16", ([1e16, 1.0, 1.0], [1e-12, 0.5, 0.5 - 1e-12]))):
            c_rates, c_w = (torch.as_tensor(x, dtype=torch.float64) for x in (c_rates, c_w))
            on_card = card.site_log_likelihoods(params, *unpack_at(card, params)[:2], params["t"],
                                                c_rates.to(DEVICE), c_w.to(DEVICE))
            on_host = host.site_log_likelihoods(host_params, *unpack_at(host, host_params)[:2],
                                                host_params["t"], c_rates.cpu(), c_w.cpu())
            spectral[name] = {"rel": rel(on_card, on_host),
                              "finite_below_0": bool(torch.isfinite(on_card).all()
                                                     and (on_card < 0).all())}
        res["site_fp64_spectral_card_vs_host"] = spectral
        del card, host, card_mh, host_mh

        # fp32 Taylor (the run's engine) against fp64 spectral on every pattern
        full64 = _bsrel_copy(torch, engine, data, DEVICE, torch.float64)
        full64.spectral = True
        sll32 = engine.site_log_likelihoods(params, *_args(unpack_at(engine, params), params))
        sll64 = full64.site_log_likelihoods(params, *_args(unpack_at(full64, params), params))
        res["site_fp32_vs_fp64"] = float((sll32 - sll64).abs().max())
        res["lnl_fp32_vs_fp64"] = float(abs(torch.dot(sll32 - sll64, engine.pattern_weights)))
        del full64
        # the folded classes against each class pruned alone
        om, w, rates, _ = unpack_at(engine, params)
        times = rates[:, None] * params["t"][None, :]
        p_mix = engine.mixture_propagators(params, om, w, times)
        folded = engine.class_site_log_likelihoods(params, om, w, params["t"], rates)
        alone = torch.cat([pruning.site_log_likelihoods(p_mix[c:c + 1], engine.leaf_partials,
                                                        engine.freqs, engine.pdata, floor=True)
                           for c in range(p_mix.shape[0])])
        res["folded_equal_to_each_class_alone"] = bool(torch.equal(folded, alone))
    log(f"[busted] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items())
        + f"; maximize_jax calls {[round(x, 3) for x in res['maximize_s']]} s")
    log(f"[busted] K1 launches {res['level_products_launches']} ({res['k1_launches_per_value']} "
        f"per mixture value over {res['levels']} levels, 3 SRV classes folded); peak "
        f"{res['peak_gb']:.2f} GB (one value+gradient {res['value_grad_peak_gb']:.2f} GB); value "
        f"{_rounded(res['value_ms'])} ms, value+gradient {_rounded(res['value_grad_ms'])} ms; one "
        f"value profiled: wall {prof['wall_ms']:.3f} ms, kernels {prof['device_ms']:.3f} ms in "
        f"{prof['launches']} launches ({len(prof['k1_launch_ms'])} K1, "
        f"{sum(prof['k1_launch_ms']):.3f} ms), idle share {prof['idle_share']:.3f}; top "
        f"{prof['top'][:3]}")
    log(f"[busted] test {res['test']}; site lnL fp64 Taylor card vs host on {n} patterns, "
        f"relative {res['site_fp64_card_vs_host_rel']:.3e} (bound {BUSTED_HOST_REL_BOUND}); "
        f"fp64 spectral card vs host {res['site_fp64_spectral_card_vs_host']} (bound "
        f"{BUSTED_SPECTRAL_HOST_REL_BOUND}); "
        f"options card vs host {res['options_card_vs_host_rel']}; fp32 Taylor vs fp64 spectral "
        f"per pattern {res['site_fp32_vs_fp64']:.3e} (bound {BUSTED_FP32_SITE_BOUND}), lnL "
        f"{res['lnl_fp32_vs_fp64']:.3e} (bound {BUSTED_FP32_TOTAL_BOUND}); folded classes "
        f"equal to each alone {res['folded_equal_to_each_class_alone']}")
    check(res["k1_launches_per_value"] == n_levels,
          f"{res['k1_launches_per_value']} K1 launches per mixture value over {n_levels} levels")
    check(res["site_fp64_card_vs_host_rel"] <= BUSTED_HOST_REL_BOUND, "BUSTED site lnL card vs host")
    for name, d in res["site_fp64_spectral_card_vs_host"].items():
        check(d["finite_below_0"] and d["rel"] <= BUSTED_SPECTRAL_HOST_REL_BOUND,
              f"BUSTED fp64 spectral site lnL card vs host at the {name} point: {d}")
    for name, d in options.items():
        check(d <= BUSTED_HOST_REL_BOUND, f"BUSTED {name} objective card vs host: {d}")
    check(res["site_fp32_vs_fp64"] <= BUSTED_FP32_SITE_BOUND, "BUSTED fp32 site lnL far from fp64")
    check(res["lnl_fp32_vs_fp64"] <= BUSTED_FP32_TOTAL_BOUND, "BUSTED fp32 lnL far from fp64")
    check(res["folded_equal_to_each_class_alone"], "BUSTED folded SRV classes differ from alone")
    check(res["level_products_launches"] > 0, "BUSTED launched no level_products kernel")
    return res


def _args(unpacked, params):
    """(omegas, weights, t, rates, srv weights) for the engine's calls."""
    om, w, rates, wsrv = unpacked
    return om, w, params["t"], rates, wsrv


def phase_busted_e(torch, aln, tree_path: str, tmp: str) -> dict:
    """``warmup busted --error-sink`` on phase 9's alignment cut to
    ERROR_SINK_CODONS codons, then ``error-filter`` on its JSON: seconds,
    K1 launches, peak memory, the branch-pinned site lnLs' seconds; the
    class posteriors, the re-mixing identity, the masked sequences."""
    import numpy as np

    from hyphy_tpu_torch.methods import busted, error_filter
    from hyphy_tpu_torch.models.bsrel import BSRELEngine

    fasta = _cut_fasta(aln, os.path.join(tmp, "busted_e.fasta"), ERROR_SINK_CODONS)
    out_json = os.path.join(tmp, "busted_e.BUSTED.json")
    argv = ["warmup", "busted", "--alignment", fasta, "--tree", tree_path, "--output", out_json,
            "--error-sink"]
    clock, res = _run_cli(torch, argv, [
        (busted, "fit_unconstrained", "unconstrained"),
        (busted, "fit_constrained", "constrained"),
        (BSRELEngine, "branch_class_site_logliks", "branch_class"),
        (busted.ancestral, "joint_reconstruct", "joint_reconstruct"),
        (busted, "substitution_map", "substitution_map"),
    ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    with open(out_json) as fh:
        result = json.load(fh)
    branches = result["branch attributes"]["0"]
    sums = np.stack([np.asarray(b["Posterior prob omega class by site"]).sum(axis=0)
                     for b in branches.values()])
    res["posterior_sum_max_dev"] = float(np.abs(sums - 1.0).max())
    res["tested_branches"] = len(branches)

    (engine, params, omegas, weights, t_b, rates, wsrv, _), sll_bk = clock.last["branch_class"]
    with torch.no_grad():
        remixed = torch.logsumexp(
            sll_bk + torch.log(weights[0].double())[None, :, None], dim=1)   # [n_sel, patterns]
        sll = engine.site_log_likelihoods(params, omegas, weights, t_b, rates, wsrv)
        res["remix_rel"] = float(((remixed - sll[None]) / sll.abs()[None]).abs().max())

    masked = os.path.join(tmp, "busted_e.masked.fasta")
    t0 = time.perf_counter()
    rc = __import__("hyphy_tpu_torch.cli", fromlist=["main"]).main(
        ["error-filter", "--json", out_json, "--output", masked])
    res["error_filter_s"] = time.perf_counter() - t0
    check(rc == 0, f"error-filter returned {rc}")
    with open(masked) as fh:
        lines = [ln.strip() for ln in fh if ln.strip()]
    seqs = [ln for ln, prev in zip(lines[1:], lines) if prev.startswith(">")]
    res["masked_sequences"] = len(seqs)
    report = error_filter.run(out_json)
    res["masked_cells"] = report.total_masked
    log(f"[busted-e] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items())
        + f"; K1 launches {res['level_products_launches']}; peak {res['peak_gb']:.2f} GB")
    log(f"[busted-e] {res['tested_branches']} tested branches: class posteriors sum to 1 within "
        f"{res['posterior_sum_max_dev']:.3e} (bound {POSTERIOR_SUM_BOUND}); pinned site lnLs "
        f"re-mixed vs the site lnL, relative {res['remix_rel']:.3e} (bound {REMIX_REL_BOUND}); "
        f"error-filter {res['error_filter_s']:.2f} s, {res['masked_cells']} cells masked, "
        f"{res['masked_sequences']} sequences")
    check(res["posterior_sum_max_dev"] <= POSTERIOR_SUM_BOUND, "class posteriors do not sum to 1")
    check(res["remix_rel"] <= REMIX_REL_BOUND, "re-mixed pinned site lnLs far from the site lnL")
    check(res["masked_sequences"] == N_TAXA and all(len(x) == 3 * ERROR_SINK_CODONS for x in seqs),
          "masked sequences lost their length")
    check(res["level_products_launches"] > 0, "BUSTED-E launched no level_products kernel")
    return res


def phase_busted_ph(torch, aln, tree_path: str, tmp: str) -> dict:
    """``warmup busted-ph --branches FG`` on phase 14's alignment cut to
    BUSTEDPH_CODONS codons, then ``clade-support`` on its JSON: seconds per
    test, K1 launches, peak memory; the three p-values, the perplexity."""
    from hyphy_tpu_torch.methods import busted, clade_support

    fasta = _cut_fasta(aln, os.path.join(tmp, "bustedph.fasta"), BUSTEDPH_CODONS)
    out_json = os.path.join(tmp, "bustedph.BUSTED-PH.json")
    argv = ["warmup", "busted-ph", "--alignment", fasta, "--tree", tree_path, "--output",
            out_json, "--branches", CONTRAST_LABELS[0]]
    clock, res = _run_cli(torch, argv, [
        (busted, "fit_unconstrained", "unconstrained"),
        (busted, "fit_constrained", "constrained"),
        (busted, "maximize", "maximize"),
    ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    null_s = clock.each["constrained"]
    res["tests_s"] = {"alternative": clock.seconds["unconstrained"] + null_s[0],
                      "background": null_s[1] if len(null_s) > 1 else 0.0,
                      "equality": clock.each["maximize"][-1]}
    with open(out_json) as fh:
        result = json.load(fh)
    ps = result["BUSTED-PH"]["uncorrected P-values for each test"]
    res["p"] = ps
    t0 = time.perf_counter()
    ecb = clade_support.run(out_json, output_json=os.path.join(tmp, "bustedph.ECB.json"))
    res["clade_support_s"] = time.perf_counter() - t0
    res["perplexity"] = ecb.perplexity
    log(f"[busted-ph] {res['command']}: {res['total_s']:.2f} s; tests, s: "
        f"{_rounded(res['tests_s'])}; K1 launches {res['level_products_launches']}; peak "
        f"{res['peak_gb']:.2f} GB; p {ps}; clade-support {res['clade_support_s']:.2f} s, "
        f"perplexity {ecb.perplexity}")
    check(all(0 <= v <= 1 for v in ps.values()), f"BUSTED-PH p-values {ps}")
    check(all(v >= 1 - 1e-12 for v in ecb.perplexity.values()), f"perplexity {ecb.perplexity}")
    check(res["level_products_launches"] > 0, "BUSTED-PH launched no level_products kernel")
    return res


def _episodic_alignment(tmp: str, n_codons: int, n_taxa=None):
    """BUSTED's positive control: codons drawn along ``random_tree_newick
    (n_taxa or N_TAXA, SEED)`` with ``utils/simulate.py::simulate_states`` under
    ``synth._mg94_generator``'s omega-0.3 generator, except that in each
    block of EPISODIC_BLOCK codons a fresh random EPISODIC_SHARE of the
    branches runs omega EPISODIC_OMEGA at the same synonymous rate: the
    branch-site (episodic) selection BUSTED tests for.  Returns (FASTA,
    newick)."""
    import numpy as np
    import scipy.linalg as sla

    from hyphy_tpu_torch.data.genetic_code import GeneticCode
    from hyphy_tpu_torch.tree.topology import Tree
    from hyphy_tpu_torch.utils import synth
    from hyphy_tpu_torch.utils.simulate import simulate_states, states_to_alignment

    t0 = time.perf_counter()
    n_taxa = n_taxa or N_TAXA
    gc = GeneticCode("Universal")
    newick = synth.random_tree_newick(n_taxa, seed=SEED)
    tree = Tree.from_newick(newick)
    lengths = np.maximum(np.asarray(tree.input_lengths[:-1]), 1e-6)
    slow = synth._mg94_generator(gc, 2.5, 0.3)
    amino = np.array(list(gc.translation))[np.asarray(gc.sense_codons)]
    fast = np.where(amino[:, None] != amino[None, :], slow * (EPISODIC_OMEGA / 0.3), slow)
    np.fill_diagonal(fast, 0.0)
    fast -= np.diag(fast.sum(axis=1))
    p_slow = np.stack([sla.expm(slow * t) for t in lengths])
    p_fast = np.stack([sla.expm(fast * t) for t in lengths])
    pi = np.full(gc.n_states, 1.0 / gc.n_states)
    rng = np.random.default_rng(SEED)
    states = np.zeros((tree.n_nodes, n_codons), dtype=np.int32)
    for lo in range(0, n_codons, EPISODIC_BLOCK):
        hi = min(lo + EPISODIC_BLOCK, n_codons)
        chosen = rng.random(len(lengths)) < EPISODIC_SHARE
        p = np.where(chosen[:, None, None], p_fast, p_slow)
        states[:, lo:hi] = simulate_states(tree, p, pi, hi - lo, rng)
    names, seqs = states_to_alignment(states, tree, "codon", gc)
    fasta = os.path.join(tmp, f"episodic_{n_taxa}.fasta")
    _write_fasta(fasta, names, seqs)
    log(f"[episodic] alignment of {n_taxa} taxa x {n_codons} codons, omega "
        f"{EPISODIC_OMEGA} on {EPISODIC_SHARE:.0%} of the branches per block of "
        f"{EPISODIC_BLOCK} codons: {time.perf_counter() - t0:.2f} s on the host")
    return fasta, newick


def _planted_scan(torch, r, share: float) -> dict:
    """The fitted unconstrained lnL against points near the planted truth:
    omega_3 at each of PLANTED_SCAN_OMEGAS with weight ``share`` times each
    of PLANTED_SCAN_SHARES, omega_1 = omega_2 set so that the per-branch
    mean omega stays the fitted one, every other parameter the fit's."""
    ll, unpack = r.context["loglik"], r.context["unpack"]
    omegas, weights, _, _ = unpack(r.alt_params)
    mean = float((omegas[0] * weights[0]).sum())
    points = []
    with torch.no_grad():
        for o3 in PLANTED_SCAN_OMEGAS:
            for f in PLANTED_SCAN_SHARES:
                w3 = f * share
                low = (mean - w3 * o3) / (1.0 - w3)
                if low < 0:
                    continue
                p = dict(r.alt_params)
                for name, v in (("test_omega_1", low), ("test_omega_2", low),
                                ("test_omega_3", o3), ("test_w_1", 0.5),
                                ("test_w_2", 1.0 - 2.0 * w3)):
                    p[name] = torch.tensor(v, dtype=torch.float64, device=DEVICE)
                points.append({"omega_3": o3, "w_3": w3,
                               "lnl_minus_fit": float(ll(p)) - r.unconstrained_lnl})
    best = max(points, key=lambda q: q["lnl_minus_fit"])
    return {"fitted_mean_omega": mean, "points": points, "best": best}


def _busted_uncapped(torch, fasta: str, newick: str, label: str, share=None) -> dict:
    """BUSTED on one input with every fit run to convergence, in fp32 and
    in fp64: each precision's seconds, lnLs, LRT, p and per-fit counters
    (iterations, restarts, evaluations, seconds, why it stopped); every lnL
    finite and below 0, the unconstrained no lower than the constrained;
    the two precisions' unconstrained lnLs within FP32_BOUND and their
    calls at 0.05 equal.  ``share``: the planted codons' share, for the
    fp64 scan of :func:`_planted_scan`."""
    from hyphy_tpu_torch.methods import busted

    res = {}
    for name in ("float32", "float64"):
        fits, restore = _fit_recorder(busted)
        os.environ["HYPHY_TPU_PRECISION"] = name
        os.environ["HYPHY_TPU_VERBOSITY"] = "1"   # one stderr line per optimizer stop
        try:
            t0 = time.perf_counter()
            r = busted.run(fasta, tree=newick, starting_points=2, device=DEVICE)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            scan = _planted_scan(torch, r, share) if share and name == "float64" else None
        finally:
            restore()
            del os.environ["HYPHY_TPU_PRECISION"], os.environ["HYPHY_TPU_VERBOSITY"]
        res[name] = {"seconds": seconds, "mg94_lnl": r.mg94.loglik,
                     "unconstrained_lnl": r.unconstrained_lnl, "null_lnl": r.null_lnl,
                     "lrt": r.lrt, "p": r.p_value, "fits": fits}
        log(f"[busted-check] {label} {name}: {seconds:.2f} s; MG94 lnL {r.mg94.loglik:.6f}, "
            f"unconstrained {r.unconstrained_lnl:.6f}, null {r.null_lnl:.6f}, LRT {r.lrt:.4f}, "
            f"p {r.p_value:.3e}; fits (iterations, restarts, evaluations, s, stop): "
            f"{_fit_summary(fits)}")
        if scan is not None:
            res[name]["scan"] = scan
            log(f"[busted-check] {label} {name}: fitted mean omega {scan['fitted_mean_omega']:.6f}; "
                f"best of {len(scan['points'])} points near the planted truth {scan['best']}")
            check(scan["best"]["lnl_minus_fit"] <= 0,
                  f"BUSTED {label} {name}: a point near the planted truth lies above the fit: "
                  f"{scan['best']}")
        torch.cuda.empty_cache()
        lnls = (r.unconstrained_lnl, r.null_lnl)
        check(all(math.isfinite(v) and v < 0 for v in lnls),
              f"BUSTED {label} {name}: lnL unconstrained {lnls[0]}, constrained {lnls[1]}")
        check(r.unconstrained_lnl >= r.null_lnl - ALT_NULL_SLACK,
              f"BUSTED {label} {name}: the unconstrained fit ends below the constrained one")
        check(r.lrt >= 0 and 0 <= r.p_value <= 1, f"BUSTED {label} {name}: LRT {r.lrt}, p {r.p_value}")
    res["fp32_vs_fp64_lnl"] = abs(res["float32"]["unconstrained_lnl"]
                                  - res["float64"]["unconstrained_lnl"])
    check(res["fp32_vs_fp64_lnl"] <= FP32_BOUND,
          f"BUSTED {label}: fp32 and fp64 unconstrained lnL {res['fp32_vs_fp64_lnl']} apart")
    check((res["float32"]["p"] <= 0.05) == (res["float64"]["p"] <= 0.05),
          f"BUSTED {label}: fp32 and fp64 call differently at 0.05")
    return res


def phase_busted_check(torch, tmp: str) -> dict:
    """BUSTED with every fit run to convergence, in fp32 and in fp64, on the
    planted alignment (BUSTED_CHECK_CODONS codons), bench.py's alignment
    (BENCH_CHECK_CODONS codons) and the episodic positive control
    (:func:`_episodic_alignment`, BUSTED_POSITIVE_CODONS codons): there p <=
    0.05 in both precisions (see :func:`_busted_uncapped` for the rest).
    The partial record goes to chiprun_out after each input."""
    from hyphy_tpu_torch.ops.level_products import level_products

    aln, fasta, tree_path = _planted_alignment(tmp)
    if BUSTED_CHECK_CODONS < N_CODONS:
        fasta = _cut_fasta(aln, os.path.join(tmp, "busted_check.fasta"), BUSTED_CHECK_CODONS)
    with open(tree_path) as fh:
        newick = fh.read().strip()
    share = sum(s < BUSTED_CHECK_CODONS for s in PLANTED_SITES) / BUSTED_CHECK_CODONS
    bench_aln, bench_newick, _, _ = _write_inputs(tmp)
    bench_fasta = _cut_fasta(bench_aln, os.path.join(tmp, "bench_check.fasta"),
                             BENCH_CHECK_CODONS)
    episodic_fasta, episodic_newick = _episodic_alignment(tmp, BUSTED_POSITIVE_CODONS)
    res = {"codons": {"planted": BUSTED_CHECK_CODONS, "bench": BENCH_CHECK_CODONS,
                      "episodic": BUSTED_POSITIVE_CODONS}}
    level_products.launches = 0
    failed = []
    for label, path, tree, planted_share in (("planted", fasta, newick, share),
                                             ("bench", bench_fasta, bench_newick, None),
                                             ("episodic", episodic_fasta, episodic_newick, None)):
        try:     # every input runs; a failed one fails the phase after the last
            res[label] = _busted_uncapped(torch, path, tree, label, planted_share)
            if label == "episodic":
                for name in ("float32", "float64"):
                    check(res[label][name]["p"] <= 0.05,
                          f"BUSTED {name} p = {res[label][name]['p']} on the episodic alignment")
        except RuntimeError as exc:
            failed.append(f"{label}: {exc}")
            log(f"[busted-check] {label} failed: {exc}")
        with open(os.path.join("chiprun_out", "busted_check_partial.json"), "w") as fh:
            json.dump(dict(res, failed=failed), fh, indent=1)
    res["level_products_launches"] = level_products.launches
    check(not failed, f"the BUSTED check failed on {failed}")
    check(res["level_products_launches"] > 0, "the BUSTED check launched no kernel")
    return res


def phase_precision(torch, tmp: str) -> dict:
    """FEL's fp32 and fp64 site calls on phase 8's input (1000 taxa x
    CI_CODONS codons), no CI, no bootstrap: the global fits capped, then
    the per-site stage run to convergence at that one fit in fp32 (Taylor)
    and in fp64 (spectral): the p <= 0.1 sets equal, alpha and beta within
    PRECISION_RATE_ATOL + PRECISION_RATE_RTOL * |fp64| at all but
    PRECISION_OUTLIER_SHARE of the sites; seconds of each."""
    import numpy as np

    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.methods import common, fel
    from hyphy_tpu_torch.ops.level_products import level_products
    from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment

    aln = synthetic_codon_alignment(N_TAXA, CI_CODONS, seed=SEED)
    fasta = os.path.join(tmp, "precision.fasta")
    _write_fasta(fasta, aln.names, aln.sequences)
    newick = random_tree_newick(N_TAXA, seed=SEED)
    res = {}
    level_products.launches = 0
    t0 = time.perf_counter()
    md = common.load_codon_data_multi(fasta, tree_newick=newick, device=DEVICE)
    settings.warmup = True
    try:
        gtr = common.fit_gtr_multi(md)
        md, gtr = common.kill_zero_branches_multi(md, gtr, "All")
        mg = common.fit_partitioned_mg94_multi(md, gtr)
    finally:
        settings.warmup = False
    torch.cuda.synchronize()
    res["global_fits_s"] = time.perf_counter() - t0
    tables = {}
    for name in ("float32", "float64"):
        os.environ["HYPHY_TPU_PRECISION"] = name
        try:
            t0 = time.perf_counter()
            tables[name], _ = fel.solve_partition(md.parts[0], mg.parts[0])
            torch.cuda.synchronize()
            res[f"{name}_s"] = time.perf_counter() - t0
        finally:
            del os.environ["HYPHY_TPU_PRECISION"]
    res["level_products_launches"] = level_products.launches
    t32, t64 = tables["float32"], tables["float64"]
    calls32, calls64 = t32[:, 4] <= 0.1, t64[:, 4] <= 0.1
    res["p_le_0.1"] = {"float32": int(calls32.sum()), "float64": int(calls64.sum())}
    res["same_calls"] = bool(np.array_equal(calls32, calls64))
    res["rates"] = {}
    for col, name in ((0, "alpha"), (1, "beta")):
        d = np.abs(t32[:, col] - t64[:, col])
        off = d > PRECISION_RATE_ATOL + PRECISION_RATE_RTOL * np.abs(t64[:, col])
        res["rates"][name] = {"outside_share": float(off.mean()),
                              "median_abs": float(np.median(d)), "max_abs": float(d.max()),
                              "median_rel": float(np.median(d / np.maximum(np.abs(t64[:, col]),
                                                                          1e-12)))}
    res["lrt_max_abs"] = float(np.abs(t32[:, 3] - t64[:, 3]).max())
    res["lrt_median_abs"] = float(np.median(np.abs(t32[:, 3] - t64[:, 3])))
    log(f"[precision] FEL per-site stage on {N_TAXA} x {CI_CODONS} codons at one capped global "
        f"fit ({res['global_fits_s']:.2f} s), uncapped: fp32 {res['float32_s']:.2f} s, fp64 "
        f"{res['float64_s']:.2f} s; p <= 0.1: {res['p_le_0.1']}, same set {res['same_calls']}; "
        f"rates {res['rates']}; LRT |d| median {res['lrt_median_abs']:.3e} max "
        f"{res['lrt_max_abs']:.3e}; K1 launches {res['level_products_launches']}")
    check(res["same_calls"], "fp32 and fp64 FEL call different sites at p <= 0.1")
    for name, r in res["rates"].items():
        check(r["outside_share"] <= PRECISION_OUTLIER_SHARE,
              f"fp32 {name} outside the tolerance at {r['outside_share']:.3f} of the sites")
    check(res["level_products_launches"] > 0, "the precision check launched no kernel")
    return res


def _syncs(torch, fn) -> list:
    """Where ``fn`` makes the host wait for the card (file:line of each
    sync that ``torch.cuda``'s sync debug mode warns about)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in seen
            if "synchroniz" in str(w.message)]


def _calls_in(module, names, fn) -> dict:
    """How often ``fn`` calls each of ``module``'s functions ``names``."""
    counts = {name: 0 for name in names}
    saved = {name: getattr(module, name) for name in names}

    def counted(name):
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return wrapped

    for name in names:
        setattr(module, name, counted(name))
    try:
        fn()
    finally:
        for name, original in saved.items():
            setattr(module, name, original)
    return counts


def _value_stats(torch, loglik, params, label: str) -> dict:
    """ms per value and value+gradient of ``loglik`` at ``params``, K1
    launches per value, and one value under the profiler."""
    from hyphy_tpu_torch.ops.level_products import level_products

    def value_and_grad():
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        v = loglik(p)
        v.backward()
        return v

    out = {}
    before = level_products.launches
    with torch.no_grad():
        loglik(params)
    out["k1_launches_per_value"] = level_products.launches - before
    out["value_grad_ms"] = _eval_stats(wall_ms(torch, value_and_grad, 3))
    with torch.no_grad():
        out["value_ms"] = _eval_stats(wall_ms(torch, lambda: loglik(params), 3))
        out["profile_value"] = profile_ms(torch, lambda: loglik(params),
                                          os.path.join("chiprun_out", f"profile_{label}.txt"))
    torch.cuda.reset_peak_memory_stats()
    value_and_grad()
    out["value_grad_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _route_ms(torch, engine, loglik, params) -> dict:
    """ms per fp32 value and value+gradient of ``loglik`` with ``engine``'s
    Taylor propagators built by the per-group loop and by one batched
    per-branch call (``bsrel.BATCHED_TIMES_PER_GROUP`` set to 0 and to
    every size), and the form the engine takes by itself."""
    from hyphy_tpu_torch.models import bsrel

    def value_and_grad():
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loglik(p).backward()

    saved, out = bsrel.BATCHED_TIMES_PER_GROUP, {}
    try:
        for name, per_group_times in (("loop", 0), ("batched", math.inf)):
            bsrel.BATCHED_TIMES_PER_GROUP = per_group_times
            with torch.no_grad():
                value = _eval_stats(wall_ms(torch, lambda: loglik(params), 3))["median"]
            out[name] = {"value_ms": value,
                         "value_grad_ms": _eval_stats(wall_ms(torch, value_and_grad, 3))["median"]}
    finally:
        bsrel.BATCHED_TIMES_PER_GROUP = saved
    out["groups"], out["branches"] = engine.n_groups, int(params["t"].shape[0])
    times = params["t"].expand(engine.srv_classes, -1)
    out["taken"] = "batched" if engine._batched(times) else "loop"
    log(f"[routes] {out}")
    return out


def _log_values(tag: str, name: str, stats: dict) -> None:
    prof = stats["profile_value"]
    log(f"[{tag}] {name}: value {_rounded(stats['value_ms'])} ms, value+gradient "
        f"{_rounded(stats['value_grad_ms'])} ms (peak {stats['value_grad_peak_gb']:.2f} GB), "
        f"{stats['k1_launches_per_value']} K1 launches per value; one value profiled: wall "
        f"{prof['wall_ms']:.3f} ms, kernels {prof['device_ms']:.3f} ms in {prof['launches']} "
        f"launches, idle share {prof['idle_share']:.3f}; top {prof['top'][:3]}")


def _rel(a, b) -> float:
    return float(((a.cpu() - b.cpu()) / b.cpu().abs()).abs().max())


def phase_relax(torch, fasta: str, tree_path: str, tmp: str) -> dict:
    """RELAX at full width on the contrast alignment through ``warmup relax
    --test FG --reference REF --models All``: seconds per stage, ms per
    value and gradient of the general-descriptive (one group per branch)
    and alternative objectives, launches, host syncs and propagator calls
    per general-descriptive value, its idle share, K1 launches, peak
    memory, the alternative on both forms of the fp32 Taylor route; the
    general-descriptive site lnL card vs host and fp32 vs fp64, the batched
    per-branch propagators against the per-group loop and against scipy;
    the test, the Test = Reference^K distributions and the JSON."""
    import numpy as np
    import scipy.linalg as sla

    from hyphy_tpu_torch import cli
    from hyphy_tpu_torch.methods import common, relax
    from hyphy_tpu_torch.ops import expm

    out_json = os.path.join(tmp, "contrast.RELAX.json")
    argv = ["warmup", "relax", "--alignment", fasta, "--tree", tree_path, "--output", out_json,
            "--test", CONTRAST_LABELS[0], "--reference", CONTRAST_LABELS[1], "--models", "All"]
    clock, res = _run_cli(torch, argv, [
        (common, "load_codon_data", "load"),
        (common, "fit_gtr", "gtr"),
        (common, "fit_partitioned_mg94", "mg94"),
        (relax, "fit_general_descriptive", "general_descriptive"),
        (relax, "fit_alternative", "alternative"),
        (relax, "fit_null", "null"),
        (relax, "fit_partitioned_descriptive", "partitioned_descriptive"),
        (cli, "write_json", "json"),
    ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    with open(out_json) as fh:
        result = json.load(fh)
    fits = result["fits"]
    check(sorted(fits) == sorted(["Nucleotide GTR", "MG94xREV with separate rates for branch sets",
                                  "General descriptive", "RELAX alternative", "RELAX null",
                                  "RELAX partitioned descriptive"]), f"RELAX fits {sorted(fits)}")
    tr = result["test results"]
    res["test"] = {k: tr[k] for k in ("LRT", "p-value", "relaxation or intensification parameter")}
    check(tr["LRT"] >= 0 and 0 <= tr["p-value"] <= 1, f"RELAX test {tr}")
    k_mle = tr["relaxation or intensification parameter"]
    dists = fits["RELAX alternative"]["Rate Distributions"]
    res["power_rel"] = max(
        max(abs(dists["Test"][i]["omega"] - dists["Reference"][i]["omega"] ** k_mle)
            / max(abs(dists["Test"][i]["omega"]), 1e-300),
            abs(dists["Test"][i]["proportion"] - dists["Reference"][i]["proportion"]))
        for i in dists["Reference"])
    check(res["power_rel"] <= RELAX_POWER_BOUND,
          f"RELAX Test omegas are not Reference omegas ^ K at equal weights: {res['power_rel']}")

    data = clock.last["load"][1]
    ge_loglik, _, _, _ = clock.last["general_descriptive"][0]
    ge_params = clock.last["general_descriptive"][1][0]
    engine = ge_loglik.engine
    alt_loglik = clock.last["null"][0][0]
    alt_params = clock.last["null"][1][2]
    k, n_branches = len(dists["Reference"]), data.tree.n_branches
    check(engine.n_groups == n_branches,
          f"the general-descriptive engine has {engine.n_groups} groups for {n_branches} branches")
    res["families"] = n_branches * k
    res["general_descriptive"] = _value_stats(torch, ge_loglik, ge_params, "relax_gd_value")
    res["alternative"] = _value_stats(torch, alt_loglik, alt_params, "relax_alt_value")
    res["alternative"]["routes"] = _route_ms(torch, alt_loglik.engine, alt_loglik, alt_params)
    with torch.no_grad():
        res["general_descriptive"]["host_syncs_per_value"] = _syncs(
            torch, lambda: ge_loglik(ge_params))
        res["general_descriptive"]["propagator_calls_per_value"] = _calls_in(
            expm, ["taylor_propagators_batched", "ladder_depth", "shared_taylor_propagators"],
            lambda: ge_loglik(ge_params))

    ones = torch.ones(1, dtype=torch.float64, device=DEVICE)
    n = min(SITE_PARITY_N, data.codon_filter.n_patterns)
    card = _bsrel_copy(torch, engine, data, DEVICE, torch.float64, n)
    host = _bsrel_copy(torch, engine, data, "cpu", torch.float64, n)
    host_params = {key: v.detach().cpu() for key, v in ge_params.items()}
    with torch.no_grad():
        om, w = relax.general_descriptive_distribution(ge_params, k, n_branches)
        hom, hw = relax.general_descriptive_distribution(host_params, k, n_branches)
        res["site_fp64_card_vs_host_rel"] = _rel(
            card.site_log_likelihoods(ge_params, om, w, ge_params["t"], ones, ones),
            host.site_log_likelihoods(host_params, hom, hw, host_params["t"], ones.cpu(),
                                      ones.cpu()))
        del host
        # the batched per-branch propagators against the per-group route's
        # own calls (``expm.ladder_depth`` and ``shared_taylor_propagators``
        # per family, as ``BSRELEngine._taylor_by_group`` makes them) on
        # RELAX_LOOP_BRANCHES branches spread over the tree, fp32 and fp64
        times = ge_params["t"][None]
        sample = np.linspace(0, n_branches - 1, RELAX_LOOP_BRANCHES).astype(int)
        loop = {}
        for name, eng in (("float32", engine), ("float64", card)):
            m = eng._family_generators(ge_params, om)
            t = times.to(eng.dtype)
            t0 = time.perf_counter()
            batched = eng._taylor_per_branch(m, k, t)                    # [1, B, K, S, S]
            torch.cuda.synchronize()
            batched_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            worst = 0.0
            for b in sample:
                for c in range(k):
                    f = int(b) * k + c
                    depth = expm.ladder_depth(m[f], t[:, b:b + 1], 11, radius=2.0)
                    p = expm.shared_taylor_propagators(m[f], t[:, b], depth)
                    worst = max(worst, float((p - batched[:, b, c]).abs().max()))
            loop[name] = {"max_abs": worst, "batched_s": batched_s, "families": int(m.shape[0]),
                          "loop_s": time.perf_counter() - t0, "loop_families": len(sample) * k}
            del batched, m
        res["batched_vs_loop"] = loop
        # fp64 per-branch propagators against scipy on three branches
        m = card._family_generators(ge_params, om).reshape(n_branches, k, 61, 61)
        p_cls = card._per_class_propagators(ge_params, om, times)[0]      # [B, K, S, S]
        branches = np.linspace(0, n_branches - 1, RELAX_EXPM_BRANCHES).astype(int)
        res["expm_max_abs"] = max(
            float(np.abs(p_cls[b, c].cpu().numpy()
                         - sla.expm(m[b, c].cpu().numpy() * float(ge_params["t"][b]))).max())
            for b in branches for c in range(k))
        # fp32 per-branch Taylor (the run's engine) against fp64 per-branch
        # Taylor on every pattern (the fp64 spectral value, K6 on B*K
        # families, is timed by --relax-check)
        full64 = _bsrel_copy(torch, engine, data, DEVICE, torch.float64)
        sll32 = engine.site_log_likelihoods(ge_params, om, w, ge_params["t"], ones, ones)
        sll64 = full64.site_log_likelihoods(ge_params, om, w, ge_params["t"], ones, ones)
        res["site_fp32_vs_fp64"] = float((sll32 - sll64).abs().max())
        del full64, card
    gd = res["general_descriptive"]
    log(f"[relax] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{key} {v:.3f}" for key, v in res["stages_s"].items())
        + f"; K1 launches {res['level_products_launches']}; peak {res['peak_gb']:.2f} GB")
    _log_values("relax", f"general descriptive ({n_branches} groups, {res['families']} families)",
                gd)
    _log_values("relax", "alternative (3 groups)", res["alternative"])
    log(f"[relax] per general-descriptive value: host syncs {gd['host_syncs_per_value']}, "
        f"propagator calls {gd['propagator_calls_per_value']}; test {res['test']}; Test = "
        f"Reference^K within {res['power_rel']:.3e} (bound {RELAX_POWER_BOUND})")
    log(f"[relax] site lnL fp64 Taylor card vs host on {n} patterns, relative "
        f"{res['site_fp64_card_vs_host_rel']:.3e} (bound {BUSTED_HOST_REL_BOUND}); fp32 vs fp64 "
        f"Taylor per pattern {res['site_fp32_vs_fp64']:.3e} (bound {BUSTED_FP32_SITE_BOUND}); "
        f"batched vs the per-group route's calls {loop} (bounds "
        f"{RELAX_LOOP_BOUND}); fp64 vs scipy on {RELAX_EXPM_BRANCHES} branches "
        f"{res['expm_max_abs']:.3e} (bound {RESAMPLE_EXPM_BOUND})")
    calls = gd["propagator_calls_per_value"]
    check(calls["taylor_propagators_batched"] == 1 and calls["ladder_depth"] == 0
          and calls["shared_taylor_propagators"] == 0,
          f"the general-descriptive value called the propagators {calls}")
    check(res["site_fp64_card_vs_host_rel"] <= BUSTED_HOST_REL_BOUND,
          "RELAX general-descriptive site lnL card vs host")
    check(res["site_fp32_vs_fp64"] <= BUSTED_FP32_SITE_BOUND,
          "RELAX fp32 general-descriptive site lnL far from fp64")
    for name, d in loop.items():
        check(d["max_abs"] <= RELAX_LOOP_BOUND[name],
              f"RELAX {name} batched propagators differ from the per-group loop: {d}")
    check(res["expm_max_abs"] <= RESAMPLE_EXPM_BOUND, "RELAX propagators against scipy")
    check(res["level_products_launches"] > 0, "RELAX launched no level_products kernel")
    return res


def phase_relax_groups(torch, aln, tree_path: str, tmp: str) -> dict:
    """RELAX group mode on the contrast alignment cut to RELAX_GROUP_CODONS
    codons, ``warmup relax --groups FG,REF,Unlabeled --reference
    Unlabeled``: seconds per stage, K1 launches, ms on both forms of the
    fp32 Taylor route; df = 2, the two K, the group objective card vs host
    (fp64 Taylor)."""
    from hyphy_tpu_torch import cli
    from hyphy_tpu_torch.methods import common, relax

    fasta = _cut_fasta(aln, os.path.join(tmp, "relax_groups.fasta"), RELAX_GROUP_CODONS)
    out_json = os.path.join(tmp, "relax_groups.RELAX.json")
    sets = CONTRAST_LABELS + ["Unlabeled"]
    argv = ["warmup", "relax", "--alignment", fasta, "--tree", tree_path, "--output", out_json,
            "--groups", ",".join(sets), "--reference", "Unlabeled"]
    clock, res = _run_cli(torch, argv, [
        (common, "load_codon_data", "load"),
        (common, "fit_gtr", "gtr"),
        (common, "fit_partitioned_mg94", "mg94"),
        (relax, "fit_alternative", "alternative"),
        (relax, "fit_null", "null"),
        (cli, "write_json", "json"),
    ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    with open(out_json) as fh:
        tr = json.load(fh)["test results"]
    res["test"] = tr
    data = clock.last["load"][1]
    loglik = clock.last["null"][0][0]
    params = clock.last["null"][1][2]
    n = min(SITE_PARITY_N, data.codon_filter.n_patterns)
    card = _bsrel_copy(torch, loglik.engine, data, DEVICE, torch.float64, n)
    host = _bsrel_copy(torch, loglik.engine, data, "cpu", torch.float64, n)
    with torch.no_grad():
        k = 3
        on_card = relax.group_objective(card, k, len(sets), False)(params)
        on_host = relax.group_objective(host, k, len(sets), False)(
            {key: v.detach().cpu() for key, v in params.items()})
    res["objective_fp64_card_vs_host_rel"] = _rel(on_card[None], on_host[None])
    res["routes"] = _route_ms(torch, loglik.engine, loglik, params)
    log(f"[relax-groups] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{key} {v:.3f}" for key, v in res["stages_s"].items())
        + f"; K1 launches {res['level_products_launches']}; peak {res['peak_gb']:.2f} GB; test "
        f"{tr}; group objective fp64 Taylor card vs host on {n} patterns, relative "
        f"{res['objective_fp64_card_vs_host_rel']:.3e} (bound {BUSTED_HOST_REL_BOUND})")
    check(tr["degrees of freedom"] == 2, f"RELAX group mode df {tr['degrees of freedom']}")
    check(sorted(tr["relaxation or intensification parameter"]) == sorted(CONTRAST_LABELS),
          f"RELAX group mode K {tr['relaxation or intensification parameter']}")
    check(tr["LRT"] >= 0 and 0 <= tr["p-value"] <= 1, f"RELAX group mode test {tr}")
    check(res["objective_fp64_card_vs_host_rel"] <= BUSTED_HOST_REL_BOUND,
          "RELAX group objective card vs host")
    check(res["level_products_launches"] > 0, "RELAX group mode launched no level_products kernel")
    return res


def _absrel_alignment(tmp: str, n_taxa: int, n_codons: int):
    """``simulated_codon_alignment(n_taxa, n_codons, seed=SEED)`` (omega 0.3
    everywhere) as FASTA and newick files."""
    from hyphy_tpu_torch.utils.synth import simulated_codon_alignment

    aln, newick = simulated_codon_alignment(n_taxa, n_codons, seed=SEED)
    fasta = os.path.join(tmp, f"absrel_{n_taxa}.fasta")
    _write_fasta(fasta, aln.names, aln.sequences)
    tree_path = os.path.join(tmp, f"absrel_{n_taxa}.nwk")
    with open(tree_path, "w") as fh:
        fh.write(newick)
    return fasta, tree_path


def _absrel_copy(torch, model, data, device, dtype, patterns=None, multiple_hits=None):
    """An ABSRELModel over ``model``'s MG94 fit and the data's (first
    ``patterns``) patterns on ``device`` in ``dtype`` on the Taylor route;
    ``multiple_hits`` overrides the model's."""
    import dataclasses

    from hyphy_tpu_torch.methods.absrel import ABSRELModel
    from hyphy_tpu_torch.models.codon import MG94Base

    mg = model.mg94
    mg94 = MG94Base(mg.gc, mg.corner_freqs, mg.frequencies.cpu().numpy(), device=device)
    mh = multiple_hits or ("Double+Triple" if model.triple else "Double" if model.mh else "None")
    saved = os.environ.get("HYPHY_TPU_PRECISION")
    os.environ["HYPHY_TPU_PRECISION"] = str(dtype).split(".")[-1]
    try:
        out = ABSRELModel(mg94, dataclasses.replace(data, device=torch.device(device)), mh,
                          model.srv, model.c_srv)
    finally:
        if saved is None:
            del os.environ["HYPHY_TPU_PRECISION"]
        else:
            os.environ["HYPHY_TPU_PRECISION"] = saved
    engine = out.engine
    if patterns is not None:
        engine.leaf_partials = engine.leaf_partials[:, :patterns].contiguous()
        engine.pattern_weights = engine.pattern_weights[:patterns]
    engine.spectral = False
    return out


def phase_absrel(torch, tmp: str) -> dict:
    """aBSREL on ``simulated_codon_alignment(ABSREL_TAXA, ABSREL_CODONS)`` through
    ``warmup absrel --srv Yes``: seconds per stage (baseline, step-up with
    its fits and classes added, polish, nulls), ms per value and gradient,
    K1 launches, peak memory; two branch nulls (and the full refit) on the
    card under the warm-up cap; the objective card vs host at mixed class
    counts (fp64 Taylor, also with Double+Triple bases), fp32 vs fp64, the
    SRV posteriors and rates, Holm's correction."""
    import numpy as np

    from hyphy_tpu_torch import cli
    from hyphy_tpu_torch.methods import absrel, common

    fasta, tree_path = _absrel_alignment(tmp, ABSREL_TAXA, ABSREL_CODONS)
    out_json = os.path.join(tmp, "absrel.ABSREL.json")
    argv = ["warmup", "absrel", "--alignment", fasta, "--tree", tree_path, "--output", out_json,
            "--srv", "Yes"]
    clock, res = _run_cli(torch, argv, [
        (common, "load_codon_data", "load"),
        (common, "fit_gtr", "gtr"),
        (common, "fit_partitioned_mg94", "mg94"),
        (absrel.ABSRELModel, "fit", "fit"),
        (absrel, "step_up", "step_up"),
        (absrel, "test_branches", "nulls"),
        (cli, "write_json", "json"),
    ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    data = clock.last["load"][1]
    model, params, _, n_classes = clock.last["nulls"][0][:4]
    params = clock.last["nulls"][1][0]
    n_step_fits = clock.last["step_up"][1][3]
    fits_s = clock.each["fit"]
    res["stages_s"] = {"gtr": clock.seconds["gtr"], "mg94": clock.seconds["mg94"],
                       "baseline": fits_s[0], "step_up": clock.seconds["step_up"],
                       "polish": fits_s[1 + n_step_fits], "nulls": clock.seconds["nulls"],
                       "json": clock.seconds["json"]}
    res["step_up"] = {"fits": n_step_fits, "s_per_fit": clock.seconds["step_up"] / max(n_step_fits, 1),
                      "classes_added": int(np.sum(n_classes) - len(n_classes))}
    res["null_fits"] = len(clock.last["nulls"][1][2])
    counts = model.classes(n_classes)

    def loglik(p):
        return model.loglik(p, counts)

    res["values"] = _value_stats(torch, loglik, params, "absrel_value")
    # the branch nulls on the card: the capped run may leave no branch's
    # last omega above 1, so two branches' are set to 4 at the fitted point
    # and their nulls fitted under the same cap (from an unfitted point, so
    # the full refit from a null's MLE runs too)
    from hyphy_tpu_torch.config import settings

    chosen = [0, model.n_branches // 2]
    point = dict(params)
    point["omega_last"] = params["omega_last"].clone()
    point["omega_last"][chosen] = 4.0
    tested = np.zeros(model.n_branches, dtype=bool)
    tested[chosen] = True
    with torch.no_grad():
        start_lnl = float(loglik(point))
    settings.warmup = True
    try:
        t0 = time.perf_counter()
        _, full_lnl, nulls = absrel.test_branches(model, point, start_lnl, n_classes, tested,
                                                  data.tree.names, 1e-4)
        torch.cuda.synchronize()
    finally:
        settings.warmup = False
    res["branch_nulls"] = {"branches": len(chosen), "s": time.perf_counter() - t0,
                           "start_lnl": start_lnl, "full_lnl": full_lnl, "null_lnl": nulls}
    with open(out_json) as fh:
        result = json.load(fh)
    rates = np.asarray(result["Synonymous site-to-site rates"])
    post = np.asarray(result["Synonymous site-posteriors"])
    res["srv"] = {"weights_sum_dev": float(abs(rates[:, 1].sum() - 1.0)),
                  "mean_rate_dev": float(abs(rates[:, 0] @ rates[:, 1] - 1.0)),
                  "posterior_sum_dev": float(np.abs(post.sum(axis=0) - 1.0).max()),
                  "posterior_shape": list(post.shape)}
    attrs = result["branch attributes"]["0"]
    tested = sorted((a["Uncorrected P-value"], a["Corrected P-value"]) for a in attrs.values()
                    if "Uncorrected P-value" in a)
    res["holm_monotone"] = all(b[1] >= a[1] - 1e-15 for a, b in zip(tested, tested[1:]))
    res["tested"] = len(tested)

    # the objective at mixed class counts 1-5, card vs host, fp64 Taylor;
    # with the run's bases and with Double+Triple per-branch bases
    mixed = np.arange(model.n_branches) % absrel.KMAX + 1
    n = min(SITE_PARITY_N, data.codon_filter.n_patterns)
    point = dict(params)
    point["delta"] = torch.full((model.n_branches,), 0.1, dtype=torch.float64, device=DEVICE)
    point["psi"] = torch.full((model.n_branches,), 0.05, dtype=torch.float64, device=DEVICE)
    host_point = {key: v.detach().cpu() for key, v in point.items()}
    res["objective_fp64_card_vs_host_rel"] = {}
    with torch.no_grad():
        for mh in ("None", "Double+Triple"):
            card = _absrel_copy(torch, model, data, DEVICE, torch.float64, n, mh)
            host = _absrel_copy(torch, model, data, "cpu", torch.float64, n, mh)
            res["objective_fp64_card_vs_host_rel"][mh] = _rel(
                card.loglik(point, card.classes(mixed))[None],
                host.loglik(host_point, host.classes(mixed))[None])
        del card, host
        # fp32 (the run's engine, per-branch Taylor) against fp64 spectral on
        # every pattern, at the mixed counts
        full64 = _absrel_copy(torch, model, data, DEVICE, torch.float64)
        full64.engine.spectral = True
        om, w = absrel.branch_distributions(params, model.classes(mixed))
        srv_rates, wsrv = model.srv_dist(params)
        sll32 = model.engine.site_log_likelihoods(params, om, w, params["t"], srv_rates, wsrv)
        sll64 = full64.engine.site_log_likelihoods(params, om, w, params["t"], srv_rates, wsrv)
        res["site_fp32_vs_fp64"] = float((sll32 - sll64).abs().max())
        del full64
    log(f"[absrel] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{key} {v:.3f}" for key, v in res["stages_s"].items())
        + f"; step-up {res['step_up']}; {res['null_fits']} branch nulls in the run, then "
        f"{res['branch_nulls']}; K1 launches "
        f"{res['level_products_launches']}; peak {res['peak_gb']:.2f} GB")
    _log_values("absrel", f"the full model ({model.n_branches} branches x {absrel.KMAX} classes, "
                          f"{model.c_srv} SRV classes)", res["values"])
    log(f"[absrel] objective fp64 Taylor card vs host at mixed class counts on {n} patterns, "
        f"relative {res['objective_fp64_card_vs_host_rel']} (bound {BUSTED_HOST_REL_BOUND}); fp32 "
        f"vs fp64 spectral per pattern {res['site_fp32_vs_fp64']:.3e} (bound "
        f"{BUSTED_FP32_SITE_BOUND}); SRV {res['srv']} (bound {POSTERIOR_SUM_BOUND}); Holm's "
        f"correction monotone over {res['tested']} tested branches: {res['holm_monotone']}")
    for mh, d in res["objective_fp64_card_vs_host_rel"].items():
        check(d <= BUSTED_HOST_REL_BOUND, f"aBSREL objective ({mh}) card vs host: {d}")
    check(res["site_fp32_vs_fp64"] <= BUSTED_FP32_SITE_BOUND, "aBSREL fp32 site lnL far from fp64")
    check(all(res["srv"][key] <= POSTERIOR_SUM_BOUND
              for key in ("weights_sum_dev", "mean_rate_dev", "posterior_sum_dev"))
          and res["srv"]["posterior_shape"] == [3, ABSREL_CODONS], f"aBSREL SRV {res['srv']}")
    check(res["holm_monotone"], "aBSREL Holm-corrected p not monotone in the uncorrected p")
    check(len(nulls) == len(chosen) and all(full_lnl >= v - ALT_NULL_SLACK
                                            for v in nulls.values()),
          f"aBSREL branch nulls on the card: {res['branch_nulls']}")
    check(res["level_products_launches"] > 0, "aBSREL launched no level_products kernel")
    return res


def _fit_recorder(module):
    """Wraps ``module.maximize`` to record each fit's counters; returns
    (the list they go to, a function that restores it)."""
    fits, original = [], module.maximize

    def recorded(*args, **kwargs):
        fits.append({})
        return original(*args, stats=fits[-1], **kwargs)

    module.maximize = recorded

    def restore():
        module.maximize = original
    return fits, restore


def _fit_summary(fits) -> list:
    return [(f["iterations"], f["restarts"], f["evaluations"], round(f["seconds"], 2), f["stop"])
            for f in fits]


def _spectral_general_descriptive(torch, r) -> dict:
    """K6 at the general-descriptive model's B*K families: seconds per fp64
    value of the general-descriptive objective on the spectral route (one
    ``eigh`` per family, in chunks) at RELAX result ``r``'s alternative MLE
    with every k_b = 1, and its relative distance from the per-branch Taylor
    route's value."""
    import numpy as np

    from hyphy_tpu_torch.methods import relax
    from hyphy_tpu_torch.models.bsrel import BSRELEngine

    loglik, _, params = r.models["alternative"]
    eng, k = loglik.engine, 3
    n_branches = int(eng.group_of_branch.shape[0])
    ge = BSRELEngine(eng.model, eng.pdata, eng.leaf_partials.cpu().numpy(),
                     eng.pattern_weights.cpu().numpy(), np.arange(n_branches))
    point = {key: v for key, v in params.items() if key.startswith("theta")}
    point.update({f"ge_omega_{i}": params[f"ref_omega_{i}"] for i in range(1, k + 1)})
    point.update({f"ge_w_{i}": params[f"ref_w_{i}"] for i in range(1, k)})
    point["t"] = params["t"]
    point["k_branch"] = torch.ones(n_branches, dtype=torch.float64, device=DEVICE)
    value = relax.general_descriptive_objective(ge, k)
    out = {"families": n_branches * k, "spectral": ge.spectral}
    with torch.no_grad():
        spectral = float(value(point))                # the first call warms the solver
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value(point)
        torch.cuda.synchronize()
        out["value_s"] = time.perf_counter() - t0
        ge.spectral = False
        taylor = float(value(point))
    out["spectral_vs_taylor_rel"] = abs(spectral - taylor) / abs(taylor)
    log(f"[relax-check] fp64 general descriptive, {out['families']} families: spectral value "
        f"{out['value_s']:.3f} s, spectral vs per-branch Taylor {out['spectral_vs_taylor_rel']:.3e} "
        f"(bound {RELAX_SPECTRAL_REL_BOUND})")
    return out


def phase_relax_check(torch, tmp: str) -> dict:
    """RELAX ``--models Minimal`` with every fit run to convergence, in fp32
    and in fp64, on the contrast alignment cut to RELAX_CHECK_CODONS codons,
    and aBSREL uncapped in fp32 on the episodic alignment along
    ABSREL_CHECK_TAXA taxa (:func:`_episodic_alignment`,
    ABSREL_CHECK_CODONS codons): seconds, lnLs and per-fit
    counters; every lnL finite and below 0, the alternative no lower than
    its null (the full aBSREL model no lower than any branch null), RELAX's
    two precisions within FP32_BOUND lnL and calling alike at 0.05; the
    fp64 general-descriptive value on the spectral route timed and held to
    the Taylor route (:func:`_spectral_general_descriptive`).  Every input
    runs; the phase fails after the last if one failed."""
    from hyphy_tpu_torch.methods import absrel, relax
    from hyphy_tpu_torch.ops.level_products import level_products

    con_aln, _, con_tree = _contrast_alignment(tmp)
    fasta = _cut_fasta(con_aln, os.path.join(tmp, "relax_check.fasta"), RELAX_CHECK_CODONS)
    with open(con_tree) as fh:
        newick = fh.read().strip()
    res = {"codons": RELAX_CHECK_CODONS}
    failed = []
    level_products.launches = 0

    def save():
        with open(os.path.join("chiprun_out", "relax_check_partial.json"), "w") as fh:
            json.dump(dict(res, failed=failed), fh, indent=1)

    for name in ("float32", "float64"):
        fits, restore = _fit_recorder(relax)
        os.environ["HYPHY_TPU_PRECISION"] = name
        try:
            t0 = time.perf_counter()
            r = relax.run(fasta, tree=newick, test=CONTRAST_LABELS[0],
                          reference=CONTRAST_LABELS[1], models="Minimal", device=DEVICE)
            torch.cuda.synchronize()
            alt, null = r.fits["RELAX alternative"], r.fits["RELAX null"]
            res[name] = {"seconds": time.perf_counter() - t0, "alternative_lnl": alt,
                         "null_lnl": null, "K": r.k, "lrt": r.lrt, "p": r.p_value,
                         "fits": fits}
            log(f"[relax-check] RELAX {name}: {res[name]['seconds']:.2f} s; alternative "
                f"{alt:.6f}, null {null:.6f}, K {r.k:.4f}, LRT {r.lrt:.4f}, p {r.p_value:.3e}; "
                f"fits (iterations, restarts, evaluations, s, stop): {_fit_summary(fits)}")
            check(all(math.isfinite(v) and v < 0 for v in (alt, null)),
                  f"RELAX {name}: lnL alternative {alt}, null {null}")
            check(alt >= null - ALT_NULL_SLACK, f"RELAX {name}: the alternative ends below its null")
            if name == "float64":
                res["spectral_general_descriptive"] = sgd = _spectral_general_descriptive(torch, r)
                check(sgd["spectral_vs_taylor_rel"] <= RELAX_SPECTRAL_REL_BOUND,
                      f"RELAX fp64 general descriptive: spectral vs Taylor {sgd}")
        except RuntimeError as exc:
            failed.append(f"RELAX {name}: {exc}")
            log(f"[relax-check] RELAX {name} failed: {exc}")
        finally:
            restore()
            del os.environ["HYPHY_TPU_PRECISION"]
            torch.cuda.empty_cache()
        save()
    if "float32" in res and "float64" in res:
        res["fp32_vs_fp64_lnl"] = abs(res["float32"]["alternative_lnl"]
                                      - res["float64"]["alternative_lnl"])
        if res["fp32_vs_fp64_lnl"] > FP32_BOUND:
            failed.append(f"RELAX fp32 and fp64 alternatives {res['fp32_vs_fp64_lnl']} apart")
        if (res["float32"]["p"] <= 0.05) != (res["float64"]["p"] <= 0.05):
            failed.append("RELAX fp32 and fp64 call differently at 0.05")

    abs_fasta, abs_newick = _episodic_alignment(tmp, ABSREL_CHECK_CODONS, ABSREL_CHECK_TAXA)
    fits, restore = _fit_recorder(absrel)
    nulls, original_tests = {}, absrel.test_branches

    def tests(*args, **kwargs):
        out = original_tests(*args, **kwargs)
        nulls.update(out[2])
        return out

    absrel.test_branches = tests
    os.environ["HYPHY_TPU_PRECISION"] = "float32"
    try:
        t0 = time.perf_counter()
        r = absrel.run(abs_fasta, tree=abs_newick, device=DEVICE)
        torch.cuda.synchronize()
        res["absrel"] = {"taxa": ABSREL_CHECK_TAXA, "codons": ABSREL_CHECK_CODONS,
                         "seconds": time.perf_counter() - t0, "baseline_lnl": r.baseline_lnl,
                         "full_lnl": r.full_lnl, "classes": [int(c) for c in r.n_classes],
                         "null_lnl": nulls, "positive": r.positive_branches,
                         "fits": len(fits), "fit_stats": fits}
        log(f"[relax-check] aBSREL float32 {ABSREL_CHECK_TAXA} x {ABSREL_CHECK_CODONS}: "
            f"{res['absrel']['seconds']:.2f} s; baseline {r.baseline_lnl:.6f}, full "
            f"{r.full_lnl:.6f}; classes added {sum(r.n_classes) - len(r.n_classes)}; {len(nulls)} "
            f"branch nulls, {len(r.positive_branches)} positive; {len(fits)} fits, iterations "
            f"{[f['iterations'] for f in fits]}")
        check(all(math.isfinite(v) and v < 0 for v in (r.baseline_lnl, r.full_lnl)),
              f"aBSREL lnL baseline {r.baseline_lnl}, full {r.full_lnl}")
        check(all(r.full_lnl >= v - ALT_NULL_SLACK for v in nulls.values()),
              "aBSREL: a branch null ends above the full model")
    except RuntimeError as exc:
        failed.append(f"aBSREL: {exc}")
        log(f"[relax-check] aBSREL failed: {exc}")
    finally:
        restore()
        absrel.test_branches = original_tests
        del os.environ["HYPHY_TPU_PRECISION"]
    res["level_products_launches"] = level_products.launches
    save()
    check(not failed, f"the RELAX check failed: {failed}")
    check(res["level_products_launches"] > 0, "the RELAX check launched no kernel")
    return res


def _protein_alignment(tmp: str):
    """Phases 24-25's protein alignment: N_TAXA x N_CODONS residues drawn
    along ``random_tree_newick(N_TAXA, SEED)`` with
    ``utils/simulate.py::simulate_states`` under WAG at unit mean rate
    (``scipy.linalg.expm`` of the copied matrix), except that at the planted
    positions below FADE_SITES the branches of the contrast tree's FG clade
    evolve under FADE's biased generator toward FADE_TARGET (rate FADE_RATE,
    bias FADE_BIAS).  Returns (alignment, FASTA, planted positions)."""
    import numpy as np
    import scipy.linalg as sla

    from hyphy_tpu_torch.data.alignment import Alignment
    from hyphy_tpu_torch.data.genetic_code import AMINO_ACIDS
    from hyphy_tpu_torch.models.protein import load_empirical, rate_matrix_from_pairs
    from hyphy_tpu_torch.tree.topology import Tree
    from hyphy_tpu_torch.utils import synth
    from hyphy_tpu_torch.utils.simulate import simulate_states, states_to_alignment

    t0 = time.perf_counter()
    tree = Tree.from_newick(synth.random_tree_newick(N_TAXA, seed=SEED))
    lengths = np.maximum(np.asarray(tree.input_lengths[:-1]), 1e-6)
    fg = _contrast_clades(tree)[0]
    wag = load_empirical("WAG")
    pi = np.asarray(wag["frequencies"], dtype=np.float64)
    pi = pi / pi.sum()
    q = rate_matrix_from_pairs(wag["rates"]) * pi[None, :]
    q -= np.diag(q.sum(axis=1))
    q /= -(pi * np.diag(q)).sum()
    # FADE's rate modifier (FADE.bf:359-377) on the unit-rate generator
    target = AMINO_ACIDS.index(FADE_TARGET)
    mult = np.ones_like(q)
    mult[:, target] = FADE_BIAS / -np.expm1(-FADE_BIAS)
    mult[target, :] = FADE_BIAS / np.expm1(FADE_BIAS)
    qb = FADE_RATE * (q - np.diag(np.diag(q))) * mult
    qb -= np.diag(qb.sum(axis=1))
    base = np.stack([sla.expm(q * t) for t in lengths])
    biased = base.copy()
    for nd in fg:
        if nd != tree.root:
            biased[nd] = sla.expm(qb * lengths[nd])
    planted = [site for site in PLANTED_SITES if site < FADE_SITES]
    rng = np.random.default_rng(SEED)
    cols = np.setdiff1d(np.arange(N_CODONS), planted)
    states = np.zeros((tree.n_nodes, N_CODONS), dtype=np.int32)
    states[:, cols] = simulate_states(tree, base, pi, len(cols), rng)
    states[:, planted] = simulate_states(tree, biased, pi, len(planted), rng)
    names, seqs = states_to_alignment(states, tree, "protein")
    fasta = os.path.join(tmp, "protein.fasta")
    _write_fasta(fasta, names, seqs)
    log(f"[protein] alignment of {N_TAXA} taxa x {N_CODONS} residues under WAG, FADE's "
        f"generator toward {FADE_TARGET} (rate {FADE_RATE}, bias {FADE_BIAS}) on the "
        f"{sum(tree.is_leaf(m) for m in fg)}-leaf FG clade at {planted}: "
        f"{time.perf_counter() - t0:.2f} s on the host")
    return Alignment(names, seqs), fasta, planted


def _leisr_run(torch, kind: str, model: str, fasta: str, tree_path: str, tmp: str) -> dict:
    """One ``warmup leisr`` run and its checks (phase 24)."""
    import numpy as np

    from hyphy_tpu_torch.methods import leisr
    from hyphy_tpu_torch.models.protein import EmpiricalProtein

    out_json = os.path.join(tmp, f"{kind}.LEISR.json")
    argv = ["warmup", "leisr", "--alignment", fasta, "--tree", tree_path, "--output", out_json,
            "--type", kind, "--model", model]
    clock, res = _run_cli(torch, argv, [
        (leisr, "fit_baseline", "baseline"),
        (leisr, "fit_sites", "site_fits"),
        (leisr, "vmapped_nelder_mead", "nelder_mead"),
        (leisr, "vmapped_profile_ci", "profile_ci"),
    ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    sec = clock.seconds
    res["stages_s"] = {"load_and_json": res["total_s"] - sec["baseline"] - sec["site_fits"],
                       "baseline_fit": sec["baseline"],
                       "site_fits": sec["site_fits"] - sec["profile_ci"],
                       "ci": sec["profile_ci"]}
    nm_evals = clock.eval_by["nelder_mead"]
    res["nelder_mead_iterations"] = (len(nm_evals) - 2) // 3
    res["nm_eval_ms"] = _eval_stats(nm_evals)
    res["ci_eval_ms"] = _eval_stats(clock.eval_by["profile_ci"])
    with open(out_json) as fh:
        result = json.load(fh)
    headers = [h[0] for h in result["MLE"]["headers"]]
    table = np.asarray(result["MLE"]["content"]["0"], dtype=np.float64)
    check(headers == ["MLE", "Lower", "Upper", "LogL global", "LogL local"],
          f"LEISR headers {headers}")

    lf, tree, _ = clock.first["baseline"]
    fit = clock.last["baseline"][1]
    part = lf.partitions[0]
    filt, mdl = part.filter, part.model
    n_sites = len(filt.duplicate_map)
    check(table.shape == (n_sites, 5) and bool(np.isfinite(table).all()),
          f"LEISR table of shape {table.shape}, finite {np.isfinite(table).all()}")
    mle, lb, ub, glob, local = table.T
    est = mle > 0
    res["table"] = {"sites": n_sites, "patterns": int(filt.n_patterns),
                    "estimated": int(est.sum()), "median_rate": float(np.median(mle[est])),
                    "ub_at_cap": int((ub >= 1e26).sum()), "lb_at_floor": int((lb <= 1e-8).sum())}
    check(bool(((lb[est] <= mle[est] + 1e-6) & (ub[est] >= mle[est] - 1e-6)).all()),
          "LEISR: LB <= MLE <= UB fails at a site with MLE > 0")
    res["local_minus_global_min"] = float((local - glob).min())
    check(res["local_minus_global_min"] >= -LEISR_LOCAL_SLACK,
          f"LEISR: LogL local below LogL global by {-res['local_minus_global_min']}")
    constant = filt.constant_pattern_mask()[filt.duplicate_map]
    res["constant_sites"] = int(constant.sum())
    check(bool((table[constant, :2] == 0).all()), "LEISR: constant sites without r = 0, LB = 0")

    # the objective: fp64 card vs host on identical inputs, fp32 vs fp64
    params = {k: v.detach() for k, v in fit.params.items()}
    host_params = {k: v.cpu() for k, v in params.items()}
    if kind == "protein":
        host_model = EmpiricalProtein(model, frequencies=mdl.frequencies.cpu().numpy(),
                                      device="cpu")
    else:
        host_model = leisr._nucleotide_model(model, filt, "cpu")
    card64 = leisr.site_log_likelihood(mdl, params, filt, tree, torch.float64, spectral=True)
    host64 = leisr.site_log_likelihood(host_model, host_params, filt, tree, torch.float64,
                                       spectral=True)
    card32 = leisr.site_log_likelihood(mdl, params, filt, tree, torch.float32, spectral=False)
    n = min(SITE_PARITY_N, filt.n_patterns)
    idx = torch.arange(n, device=DEVICE)
    f64 = dict(dtype=torch.float64, device=DEVICE)
    res["site_fp64_card_vs_host_rel"] = {}
    with torch.no_grad():
        for r in LEISR_RATES:
            rr = torch.full((n,), r, **f64)
            card, host = card64(idx, rr).cpu(), host64(idx.cpu(), rr.cpu())
            res["site_fp64_card_vs_host_rel"][str(r)] = float(((card - host).abs()
                                                               / host.abs()).max())
        rows = torch.arange(filt.n_patterns, device=DEVICE)
        ones = torch.ones(rows.shape[0], **f64)
        res["site_fp32_vs_fp64"] = float((card32(rows, ones).double()
                                          - card64(rows, ones)).abs().max())
        res["site_eval_fp32_ms"] = _event_and_wall_ms(torch, lambda: card32(rows, ones), 3)
        # the profile CI of the first variable patterns, fp32 against fp64
        r_all = clock.last["site_fits"][1][0]
        variable = np.nonzero(~filt.constant_pattern_mask())[0][:LEISR_CI_SITES]
        ci_idx = torch.as_tensor(variable, device=DEVICE)
        r_ci = torch.as_tensor(r_all[variable], **f64)
        bounds = {}
        for name, obj in (("float64", card64), ("float32", card32)):
            bounds[name] = [b.cpu().numpy() for b in leisr.vmapped_profile_ci(
                obj, ci_idx, r_ci, obj(ci_idx, r_ci))]
    at_cap = [(a <= 1e-8 * (1 + 1e-9)) & (b <= 1e-8 * (1 + 1e-9)) if k == 0 else
              (a >= 1e26 * (1 - 1e-9)) & (b >= 1e26 * (1 - 1e-9))
              for k, (a, b) in enumerate(zip(bounds["float32"], bounds["float64"]))]
    rel = [np.where(cap, 0.0, np.abs(a - b) / np.abs(b))
           for cap, a, b in zip(at_cap, bounds["float32"], bounds["float64"])]
    res["ci_fp32_vs_fp64"] = {"sites": len(variable), "lower_max_rel": float(rel[0].max()),
                              "upper_max_rel": float(rel[1].max()),
                              "lower_both_at_floor": int(at_cap[0].sum()),
                              "upper_both_at_cap": int(at_cap[1].sum())}
    log(f"[leisr] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items())
        + f"; Nelder-Mead iterations {res['nelder_mead_iterations']}")
    log(f"[leisr] {kind}: K1 launches {res['level_products_launches']}; peak "
        f"{res['peak_gb']:.2f} GB; batched site evaluations, Nelder-Mead "
        f"{_rounded(res['nm_eval_ms'])} ms, CI {_rounded(res['ci_eval_ms'])} ms; one fp32 "
        f"evaluation of {filt.n_patterns} patterns {_rounded(res['site_eval_fp32_ms'])}; "
        f"table {res['table']}")
    log(f"[leisr] {kind}: site lnL fp64 card vs host on {n} patterns (relative) "
        f"{ {k: f'{v:.3e}' for k, v in res['site_fp64_card_vs_host_rel'].items()} } (bound "
        f"{LEISR_HOST_REL_BOUND}); fp32 Taylor vs fp64 on {filt.n_patterns} patterns "
        f"{res['site_fp32_vs_fp64']:.3e} (bound {SITE_FP32_BOUND}); LogL local - global min "
        f"{res['local_minus_global_min']:.3e}; CI fp32 vs fp64 {res['ci_fp32_vs_fp64']} "
        f"(bound {LEISR_CI_REL_BOUND})")
    for r, d in res["site_fp64_card_vs_host_rel"].items():
        check(d <= LEISR_HOST_REL_BOUND, f"LEISR site lnL card vs host at r = {r}: {d}")
    check(res["site_fp32_vs_fp64"] <= SITE_FP32_BOUND, "LEISR fp32 site lnL far from fp64")
    check(max(res["ci_fp32_vs_fp64"]["lower_max_rel"], res["ci_fp32_vs_fp64"]["upper_max_rel"])
          <= LEISR_CI_REL_BOUND, f"LEISR CI fp32 vs fp64 {res['ci_fp32_vs_fp64']}")
    check(res["level_products_launches"] > 0, "LEISR launched no level_products kernel")
    return res


def phase_leisr(torch, prot_fasta: str, nuc_fasta: str, tree_path: str, tmp: str) -> dict:
    """LEISR at full width: ``warmup leisr --type protein --model LG`` on the
    protein alignment and ``warmup leisr --type nucleotide --model GTR`` on
    bench.py's alignment read as nucleotides (1000 x 6144 nt), in-process:
    seconds per stage (load, baseline fit, site fits, CI), Nelder-Mead
    iterations, ms per batched site evaluation, K1 launches, peak memory;
    the site lnL card vs host (fp64) at r = 1 and three other rates, fp32
    vs fp64 per pattern, LB <= MLE <= UB, LogL local >= LogL global, r = 0
    at constant sites, the CI of 64 sites fp32 against fp64."""
    res = {}
    launches = 0
    for kind, model, fasta in (("protein", "LG", prot_fasta), ("nucleotide", "GTR", nuc_fasta)):
        res[kind] = _leisr_run(torch, kind, model, fasta, tree_path, tmp)
        launches += res[kind]["level_products_launches"]
        torch.cuda.empty_cache()
    res["level_products_launches"] = launches
    return res


def phase_fade(torch, prot_aln, planted, con_tree: str, tmp: str) -> dict:
    """FADE on the protein alignment's first FADE_SITES residues along the
    contrast tree, ``warmup fade --model WAG --branches FG`` (grid 20: 400
    points, all 20 residues, Variational-Bayes), in-process: seconds per
    target (grid pass, posterior), grid points per chunk, K1 launches, peak
    memory; six grid points card vs host (fp64) and fp32 vs fp64, the
    biased propagators at bias 50 against ``scipy.linalg.expm``,
    Prob[bias>0] in [0, 1], the planted residues' Prob[bias>0] toward
    FADE_TARGET above the rest's."""
    import dataclasses

    import numpy as np
    import scipy.linalg as sla

    from hyphy_tpu_torch.data.genetic_code import AMINO_ACIDS
    from hyphy_tpu_torch.methods import fade
    from hyphy_tpu_torch.models.protein import EmpiricalProtein
    from hyphy_tpu_torch.ops import expm as expm_ops
    from hyphy_tpu_torch.ops import pruning

    fasta = os.path.join(tmp, "fade.fasta")
    _write_fasta(fasta, prot_aln.names, [s[:FADE_SITES] for s in prot_aln.sequences])
    out_json = os.path.join(tmp, "protein.FADE.json")
    argv = ["warmup", "fade", "--alignment", fasta, "--tree", con_tree, "--output", out_json,
            "--model", "WAG", "--branches", CONTRAST_LABELS[0]]
    with _recorded_solves([]) as chunks:          # FADE's grid passes are FUBAR's
        clock, res = _run_cli(torch, argv, [
            (fade, "fit_baseline", "baseline"),
            (fade, "grid_pruning", "grid_pruning"),
            (fade, "grid_pass", "grid_pass"),
            (fade, "posterior_over_grid", "posterior"),
        ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    res["grid_pass_s"] = clock.each["grid_pass"]
    res["posterior_s"] = clock.each["posterior"]
    res["chunks"] = chunks[0]
    res["chunks_per_pass"] = -(-chunks[0]["items"] // chunks[0]["chunk"])
    with open(out_json) as fh:
        result = json.load(fh)
    check(sorted(result["MLE"]["content"]) == sorted(AMINO_ACIDS),
          f"FADE residues {sorted(result['MLE']['content'])}")
    tables = {r: np.asarray(v["0"], dtype=np.float64) for r, v in result["MLE"]["content"].items()}
    p_pos = np.stack([tables[r][:, 2] for r in AMINO_ACIDS])           # [20, sites]
    check(all(t.shape == (FADE_SITES, 4) for t in tables.values()), "FADE table shapes")
    check(bool(np.isfinite(p_pos).all() and (p_pos >= 0).all() and (p_pos <= 1 + 1e-12).all()),
          "FADE Prob[bias>0] outside [0, 1]")
    k = AMINO_ACIDS.index(FADE_TARGET)
    rest = np.setdiff1d(np.arange(FADE_SITES), planted)
    res["target"] = {"planted_p": p_pos[k, planted].tolist(),
                     "planted_mean": float(p_pos[k, planted].mean()),
                     "rest_mean": float(p_pos[k, rest].mean()),
                     "planted_ge_0.9": int((p_pos[k, planted] >= 0.9).sum()),
                     "unplanted_sites_ge_0.9_any_residue": int((p_pos[:, rest] >= 0.9).any(0).sum()),
                     "site_annotations": result["site annotations"]}

    # a grid chunk toward the target: card vs host in fp64, fp32 vs fp64
    gp, grid_t, _ = clock.last["grid_pass"][0]
    mdl, filt, tree, t_hat, tested = clock.first["grid_pruning"]
    host_model = EmpiricalProtein("WAG", frequencies=mdl.frequencies.cpu().numpy(), device="cpu")
    gp_host = fade.grid_pruning(host_model, filt, tree, t_hat.detach().cpu(), tested)
    gp64 = dataclasses.replace(gp, leaves=gp.leaves.double(), dtype=torch.float64)
    pts = torch.as_tensor(FADE_HOST_POINTS, device=DEVICE)
    with torch.no_grad():
        card64 = pruning.site_log_likelihoods(gp64.propagators(grid_t[pts], k), gp64.leaves,
                                              gp64.freqs, gp64.schedule).cpu()
        host64 = pruning.site_log_likelihoods(gp_host.propagators(grid_t[pts].cpu(), k),
                                              gp_host.leaves, gp_host.freqs, gp_host.schedule)
        card32 = pruning.site_log_likelihoods(gp.propagators(grid_t[pts], k), gp.leaves,
                                              gp.freqs.to(gp.dtype), gp.schedule).cpu()
    finite = torch.isfinite(host64)
    res["host_points"] = FADE_HOST_POINTS
    res["card_vs_host_inf_equal"] = bool(torch.equal(torch.isfinite(card64), finite)
                                         and torch.equal(torch.isfinite(card32), finite))
    res["minus_inf_entries"] = int((~finite).sum())
    res["card_vs_host_rel"] = float(((card64 - host64).abs() / host64.abs())[finite].max())
    res["fp32_vs_fp64"] = float((card32 - card64)[finite].abs().max())
    # the biased propagators at bias 50 against scipy, on tested branches
    top = grid_t[pts][grid_t[pts][:, 1] == grid_t[:, 1].max()]
    rows = gp.tested_rows[:FADE_EXPM_BRANCHES]
    q = fade.biased_generators(gp.s_pi, top, k)
    with torch.no_grad():
        p64 = expm_ops.taylor_propagators_batched(
            q, gp.tested_t[:FADE_EXPM_BRANCHES, None].expand(-1, top.shape[0])).cpu().numpy()
        p32 = gp.propagators(top, k)[:, rows].transpose(0, 1).double().cpu().numpy()
    want = np.stack([[sla.expm(qg * float(tb)) for qg in q.cpu().numpy()]
                     for tb in gp.tested_t[:FADE_EXPM_BRANCHES].cpu().numpy()])
    res["expm_bias50"] = {"float64": float(np.abs(p64 - want).max()),
                          "float32": float(np.abs(p32 - want).max()),
                          "points": top.cpu().numpy().tolist()}
    per_target = [g + p for g, p in zip(res["grid_pass_s"], res["posterior_s"])]
    log(f"[fade] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{key} {v:.3f}" for key, v in res["stages_s"].items())
        + f"; per target: grid pass {_rounded(_eval_stats(res['grid_pass_s']))} s, posterior "
        f"{_rounded(_eval_stats(res['posterior_s']))} s, both {sum(per_target):.2f} s; chunk "
        f"{res['chunks']} ({res['chunks_per_pass']} per pass)")
    log(f"[fade] K1 launches {res['level_products_launches']}; peak {res['peak_gb']:.2f} GB; "
        f"toward {FADE_TARGET}: planted Prob[bias>0] "
        f"{[round(x, 4) for x in res['target']['planted_p']]} (mean "
        f"{res['target']['planted_mean']:.4f}, the rest {res['target']['rest_mean']:.4f}); "
        f"planted >= 0.9: {res['target']['planted_ge_0.9']}; unplanted sites >= 0.9 for any "
        f"residue: {res['target']['unplanted_sites_ge_0.9_any_residue']}")
    log(f"[fade] grid points {FADE_HOST_POINTS} toward {FADE_TARGET}: fp64 card vs host max rel "
        f"{res['card_vs_host_rel']:.3e} (bound {FADE_HOST_REL_BOUND}), -inf at the same "
        f"{res['minus_inf_entries']} entries {res['card_vs_host_inf_equal']}; fp32 vs fp64 "
        f"{res['fp32_vs_fp64']:.3e} (bound {SITE_FP32_BOUND}); biased propagators at bias 50 vs "
        f"scipy {res['expm_bias50']} (bounds {FADE_EXPM_BOUND})")
    check(res["card_vs_host_inf_equal"], "FADE grid: -inf at other entries on card and host")
    check(res["card_vs_host_rel"] <= FADE_HOST_REL_BOUND, "FADE grid: card vs host")
    check(res["fp32_vs_fp64"] <= SITE_FP32_BOUND, "FADE grid: fp32 far from fp64")
    for name, bound in FADE_EXPM_BOUND.items():
        check(res["expm_bias50"][name] <= bound, f"FADE {name} biased propagators vs scipy")
    check(res["target"]["planted_mean"] > res["target"]["rest_mean"],
          f"FADE toward {FADE_TARGET}: planted mean {res['target']['planted_mean']} not above "
          f"the rest's {res['target']['rest_mean']}")
    check(res["level_products_launches"] > 0, "FADE launched no level_products kernel")
    return res


def phase_fmm(torch, fasta: str, tree_path: str, tmp: str) -> dict:
    """FitMultiModel at full width on bench.py's alignment, ``warmup fmm``,
    in-process: seconds per fit (GTR, MG94, 1H, each coarse and polish fit
    of 2H and 3H), ms per GDD value and value+gradient with K1 launches per
    value (3 classes folded), peak memory; the GDD site lnL at the fitted 3H
    point card vs host (fp64 Taylor, and spectral), fp32 vs fp64 per
    pattern, the class weights' sums, every lnL, LRT and evidence ratio
    finite, the JSON's keys."""
    import numpy as np

    from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
    from hyphy_tpu_torch.methods import common, fmm
    from hyphy_tpu_torch.models.codon import MG94xREVMultiHitGDD

    out_json = os.path.join(tmp, "bench.FMM.json")
    argv = ["warmup", "fmm", "--alignment", fasta, "--tree", tree_path, "--output", out_json]
    clock, res = _run_cli(torch, argv, [
        (common, "fit_gtr", "gtr"),
        (common, "fit_partitioned_mg94", "mg94"),
        (fmm, "_fit_one", "gdd"),
        (LikelihoodFunction, "fit", "fit"),
    ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    fits = clock.each["fit"]
    gdd_fits = fits[-11:]
    res["fits_s"] = {"gtr_and_mg94": fits[:-11], "1H": gdd_fits[0],
                     "2H_coarse": gdd_fits[1:4], "2H_polish": gdd_fits[4:6],
                     "3H_coarse": gdd_fits[6:9], "3H_polish": gdd_fits[9:11]}
    check(len(fits) >= 13, f"FMM ran {len(fits)} fits")
    with open(out_json) as fh:
        result = json.load(fh)
    check(sorted(result) == FMM_JSON_KEYS, f"FMM JSON keys {sorted(result)}")
    lnls = {name: fit["Log Likelihood"] for name, fit in result["fits"].items()}
    tests = result["test results"]
    er = {k: np.asarray(v, dtype=np.float64) for k, v in result["Evidence Ratios"].items()}
    sll = {k: np.asarray(v, dtype=np.float64) for k, v in result["Site Log Likelihood"].items()}
    check(len(lnls) == 4 and all(math.isfinite(v) for v in lnls.values()), f"FMM lnLs {lnls}")
    check(all(math.isfinite(t["LRT"]) and 0.0 <= t["p-value"] <= 1.0 for t in tests.values()),
          f"FMM tests {tests}")
    check(all(v.shape == (1, N_CODONS) and np.isfinite(v).all() for v in er.values()),
          "FMM evidence ratios")
    check(all(v.shape == (1, N_CODONS) and np.isfinite(v).all() for v in sll.values()),
          "FMM site lnLs")
    res["lnl"], res["tests"] = lnls, tests

    # the class weights of the three GDD fits, as the JSON reports them
    weight_sums = [sum(w for _, w in fit["Rate Distributions"]
                       ["non-synonymous/synonymous rate ratio"])
                   for fit in result["fits"].values() if "Rate Distributions" in fit]
    check(len(weight_sums) == 3, f"FMM rate distributions of {len(weight_sums)} fits")

    # the fitted 3H point: its value and gradient, card vs host, fp32 vs fp64
    fit3, model, _ = clock.last["gdd"][1]
    lf = fit3.lf
    params = {k: v.detach() for k, v in fit3.params.items()}
    with torch.no_grad():
        omegas, weights = model.class_distribution(params)
    weight_sums.append(float(weights.double().sum()))
    res["class_distribution"] = {"omegas": omegas.cpu().tolist(), "weights": weights.cpu().tolist()}
    res["weight_sum_minus_1"] = max(abs(w - 1.0) for w in weight_sums)
    res["value"] = _value_stats(torch, lf.loglik, params, "fmm_value")
    part = lf.partitions[0]
    sub = part.filter.subset_sites(np.arange(3 * FMM_HOST_SITES))     # nucleotide columns
    host_model = MG94xREVMultiHitGDD(
        model.gc, model.corner_freqs, model.frequencies.cpu().numpy(), model.branch_groups,
        model.n_groups, hits=model.hits, rate_classes=model.rate_classes,
        triple_islands=model.triple_islands, device="cpu")
    host_params = {k: v.cpu() for k, v in params.items()}
    res["site_fp64_card_vs_host_rel"] = {}
    with torch.no_grad():
        for route in ("taylor", "spectral"):
            model.spectral = host_model.spectral = route == "spectral"
            try:
                card = LikelihoodFunction([Partition(sub, part.tree, model)], dtype="float64",
                                          device=DEVICE).site_log_likelihoods(params)[0].cpu()
                host = LikelihoodFunction([Partition(sub, part.tree, host_model)],
                                          dtype="float64",
                                          device="cpu").site_log_likelihoods(host_params)[0]
            finally:
                model.spectral = host_model.spectral = None
            res["site_fp64_card_vs_host_rel"][route] = float(((card - host).abs()
                                                              / host.abs()).max())
        model.spectral = False
        try:
            lf64 = LikelihoodFunction(lf.partitions, dtype="float64", device=DEVICE)
            s64 = lf64.site_log_likelihoods(params)[0]
        finally:
            model.spectral = None
        s32 = lf.site_log_likelihoods(params)[0]
        res["site_fp32_vs_fp64"] = float((s32.double() - s64).abs().max())
    log(f"[fmm] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{key} {v:.3f}" for key, v in res["stages_s"].items())
        + f"; fits, s: {_rounded(res['fits_s'])}")
    val = res["value"]
    log(f"[fmm] K1 launches {res['level_products_launches']}; peak {res['peak_gb']:.2f} GB; GDD "
        f"value {_rounded(val['value_ms'])} ms, value+gradient {_rounded(val['value_grad_ms'])} "
        f"ms, K1 launches per value {val['k1_launches_per_value']}; one value profiled: wall "
        f"{val['profile_value']['wall_ms']:.3f} ms, kernels {val['profile_value']['device_ms']:.3f} "
        f"ms in {val['profile_value']['launches']} launches, idle share "
        f"{val['profile_value']['idle_share']:.3f}")
    log(f"[fmm] lnL {lnls}; tests {tests}; 3H classes {res['class_distribution']}; GDD site "
        f"lnL card vs host on {sub.n_patterns} patterns (fp64, relative) "
        f"{res['site_fp64_card_vs_host_rel']} (bounds Taylor {FMM_HOST_REL_BOUND}, spectral "
        f"{FMM_SPECTRAL_HOST_REL_BOUND}); fp32 vs fp64 Taylor {res['site_fp32_vs_fp64']:.3e} "
        f"(bound {SITE_FP32_BOUND})")
    check(res["weight_sum_minus_1"] <= FMM_WEIGHT_SUM_BOUND, "FMM class weights do not sum to 1")
    check(res["site_fp64_card_vs_host_rel"]["taylor"] <= FMM_HOST_REL_BOUND,
          "FMM GDD site lnL card vs host (Taylor)")
    check(res["site_fp64_card_vs_host_rel"]["spectral"] <= FMM_SPECTRAL_HOST_REL_BOUND,
          "FMM GDD site lnL card vs host (spectral)")
    check(res["site_fp32_vs_fp64"] <= SITE_FP32_BOUND, "FMM fp32 GDD site lnL far from fp64")
    check(res["level_products_launches"] > 0, "FMM launched no level_products kernel")
    return res


def phase_bgm(torch, aln, tree_path: str, tmp: str) -> dict:
    """BGM on the planted alignment cut to BGM_CODONS codons at full taxa,
    ``warmup bgm`` at its defaults (100000 steps, 10000 burn-in, 100
    samples, one parent, min-subs 1), in-process: seconds per stage (the
    fits and K8 on the card, the families and the order-MCMC on the host),
    K1 launches, peak memory; the substitution map from the card's fp64
    joint states equal to the one from the host's fp64 K8 on the same
    propagators, the cells where the card's fp32 K8 gives another map; the
    table's P[1->2], P[2->1] in [0, 1] with sum at most 1."""
    import numpy as np

    from hyphy_tpu_torch.methods import bgm, common, slac
    from hyphy_tpu_torch.ops import ancestral, pruning

    fasta = _cut_fasta(aln, os.path.join(tmp, "bgm.fasta"), BGM_CODONS)
    out_json = os.path.join(tmp, "planted.BGM.json")
    argv = ["warmup", "bgm", "--alignment", fasta, "--tree", tree_path, "--output", out_json]
    clock, res = _run_cli(torch, argv, [
        (common, "load_codon_data", "load"),
        (common, "fit_gtr", "gtr"),
        (common, "fit_partitioned_mg94", "mg94"),
        (ancestral, "joint_reconstruct", "joint_reconstruction"),
        (bgm, "substitution_counts", "substitution_map"),
        (bgm.DiscreteBGM, "__init__", "families"),
        (bgm.DiscreteBGM, "order_mcmc", "order_mcmc"),
    ])
    res["command"] = " ".join(["python -m hyphy_tpu_torch"] + [a.replace(tmp, "<tmp>") for a in argv])
    res["stages_s"] = dict(clock.seconds)
    with open(out_json) as fh:
        result = json.load(fh)
    check("error" not in result, f"BGM: {result.get('error')}")
    rows = np.asarray(result["MLE"]["content"]["0"], dtype=np.float64)
    counts, sites, _ = clock.last["substitution_map"][1]
    n = counts.shape[1]
    check(rows.shape == (n * (n - 1) // 2, 8), f"BGM table of shape {rows.shape} for {n} sites")
    p12, p21, either = rows[:, 2], rows[:, 3], rows[:, 4]
    res["sites"], res["branches"], res["pairs"] = int(n), int(counts.shape[0]), int(rows.shape[0])
    res["substitutions"] = int(counts.sum())
    res["p_max"] = float(either.max())
    res["pairs_p_ge_0.5"] = int((either >= 0.5).sum())
    res["trace"] = [min(result["trace"]), max(result["trace"]), len(result["trace"])]
    check(bool(((p12 >= 0) & (p12 <= 1) & (p21 >= 0) & (p21 <= 1)).all()),
          "BGM P[1->2] or P[2->1] outside [0, 1]")
    check(bool((p12 + p21 <= 1 + BGM_PROB_SLACK).all()), "BGM P[1->2] + P[2->1] above 1")
    check(bool(np.allclose(either, p12 + p21, rtol=0, atol=1e-12)), "BGM P[1<->2] is not the sum")
    check(len(result["trace"]) == 100 and bool(np.isfinite(result["trace"]).all()),
          "BGM score trace")

    # the map from the card's fp64 states against the host's fp64 K8 on the
    # same propagators and leaf partials, and the cells fp32 K8 moves
    data = clock.last["load"][1]
    filt, tree = data.codon_filter, data.tree
    aa = np.asarray(data.genetic_code.sense_amino_acids)
    leaves = slac._leaf_state_coding(filt)

    def binary_map(internal):
        states = np.concatenate([leaves, internal.cpu().numpy()], axis=0)[:, filt.duplicate_map]
        states = np.where(states < 0, -1, states)
        return bgm.substitution_counts(states, tree.parent, data.tested_branches,
                                       amino_of_state=aa, min_subs=0)[0]

    (p_mat, lp, freqs, schedule), joint = clock.last["joint_reconstruction"]
    with torch.no_grad():
        t0 = time.perf_counter()
        host = ancestral.joint_reconstruct(p_mat.cpu(), lp.cpu(), freqs.cpu(),
                                           pruning.build_pruning_data(tree, "cpu"))
        res["host_joint_s"] = time.perf_counter() - t0
        f32 = ancestral.joint_reconstruct(p_mat.float(), lp.float(), freqs.float(), schedule)
        torch.cuda.synchronize()
    card_map, host_map, f32_map = (binary_map(j.internal_states) for j in (joint, host, f32))
    res["map_cells"] = int(card_map.size)
    res["fp64_map_card_vs_host_equal"] = bool(np.array_equal(card_map, host_map))
    res["fp64_states_card_vs_host_equal"] = bool(torch.equal(joint.internal_states.cpu(),
                                                             host.internal_states))
    res["fp32_map_cells_differing"] = int((f32_map != card_map).sum())
    res["fp32_map_sites_differing"] = int((f32_map != card_map).any(axis=0).sum())
    res["run_map_equal"] = bool(np.array_equal(card_map[:, sites], counts))
    log(f"[bgm] {res['command']}: {res['total_s']:.2f} s; stages, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items())
        + f"; K1 launches {res['level_products_launches']}; peak {res['peak_gb']:.2f} GB")
    log(f"[bgm] {n} sites with >= 1 non-synonymous substitution over {res['branches']} "
        f"branches ({res['substitutions']} substitutions), {res['pairs']} pairs, max P[1<->2] "
        f"{res['p_max']:.4f}, {res['pairs_p_ge_0.5']} pairs at >= 0.5; score trace "
        f"{res['trace']}")
    log(f"[bgm] substitution map ({res['map_cells']} branch x site cells): fp64 card vs host K8 "
        f"equal {res['fp64_map_card_vs_host_equal']} (states equal "
        f"{res['fp64_states_card_vs_host_equal']}; host K8 {res['host_joint_s']:.2f} s); fp32 K8 "
        f"on the card moves {res['fp32_map_cells_differing']} cells at "
        f"{res['fp32_map_sites_differing']} sites")
    check(res["fp64_map_card_vs_host_equal"], "BGM fp64 substitution map: card differs from host")
    check(res["run_map_equal"], "BGM: the run's map differs from its joint states' map")
    check(res["level_products_launches"] > 0, "BGM launched no level_products kernel")
    return res


def _recombinant_alignment(tmp: str):
    """GARD's input: two halves of GARD_HALF sites, each simulated under GTR
    (``utils/simulate.py``) along its own ``random_tree_newick(GARD_TAXA,
    seed)``, joined per taxon: one breakpoint after site GARD_HALF."""
    import numpy as np
    import scipy.linalg as sla

    from hyphy_tpu_torch.tree.topology import Tree
    from hyphy_tpu_torch.utils.simulate import simulate_states, states_to_alignment
    from hyphy_tpu_torch.utils.synth import random_tree_newick

    pi = np.asarray(GARD_FREQS)
    q = np.zeros((4, 4))
    for r, (i, j) in zip(GARD_RATES, [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]):
        q[i, j], q[j, i] = r * pi[j], r * pi[i]
    np.fill_diagonal(q, -q.sum(axis=1))
    q /= -(pi * np.diag(q)).sum()
    rng = np.random.default_rng(SEED)
    seqs = {}
    for tree_seed in GARD_TREE_SEEDS:
        tree = Tree.from_newick(random_tree_newick(GARD_TAXA, seed=tree_seed))
        lengths = np.maximum(np.asarray(tree.input_lengths[:-1]), 1e-6)
        p = np.stack([sla.expm(q * t) for t in lengths])
        names, part = states_to_alignment(simulate_states(tree, p, pi, GARD_HALF, rng), tree,
                                          "nucleotide")
        for name, s in zip(names, part):
            seqs[name] = seqs.get(name, "") + s
    names = sorted(seqs, key=lambda name: int(name[1:]))
    fasta = os.path.join(tmp, "recombinant.fasta")
    _write_fasta(fasta, names, [seqs[n] for n in names])
    return fasta


def phase_gard(torch, tmp: str) -> dict:
    """GARD through ``gard.run`` on the recombinant alignment under
    ``warmup`` (every L-BFGS capped at 3 iterations: one uncapped candidate
    fit takes ~10 s on the card, PERF.md), with the search capped as set
    below (at most GARD_CANDIDATES single-breakpoint candidates): seconds of
    the host stages (TN93, NJ) and of each candidate fit with its
    evaluations and K1 launches; a breakpoint of the best model within
    GARD_BREAKPOINT_SLACK sites of the planted one, its c-AIC below the
    baseline's; a second run resumed from the first one's checkpoint fits
    only the baseline and ends alike; then the baseline and the best model
    fitted to convergence in fp32, their c-AIC difference against the
    search's 0.01 threshold, and the baseline again in fp64 (fp32's c-AIC
    rounding against that threshold)."""
    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.data.alignment import read_alignment
    from hyphy_tpu_torch.data.filter import DataFilter
    from hyphy_tpu_torch.likelihood import LikelihoodFunction
    from hyphy_tpu_torch.methods import gard
    from hyphy_tpu_torch.ops.level_products import level_products

    fasta = _recombinant_alignment(tmp)
    filt = DataFilter.from_alignment(read_alignment(fasta), "nucleotide")
    n_variable = len(gard._variable_sites(filt))
    stride = -(-n_variable // GARD_CANDIDATES)
    options = dict(candidate_stride=stride, population=GARD_POPULATION,
                   stagnant_generations=GARD_STAGNANT, max_breakpoints=GARD_MAX_BREAKPOINTS)
    checkpoint = os.path.join(tmp, "recombinant.GARD.checkpoint.json")
    fits, host_s, evaluations, fit_calls = [], {"tn93": 0.0, "nj": 0.0}, [0], [0]
    saved = [(gard._Evaluator, "evaluate"), (gard, "tn93_distance"), (gard, "infer_nj_tree"),
             (LikelihoodFunction, "loglik"), (LikelihoodFunction, "fit")]
    originals = [getattr(owner, name) for owner, name in saved]
    evaluate, tn93, nj, loglik, fit = originals

    def timed_evaluate(self, breakpoints):
        before, k1, n_eval = self.evaluations, level_products.launches, evaluations[0]
        t0 = time.perf_counter()
        out = evaluate(self, breakpoints)
        torch.cuda.synchronize()
        if self.evaluations > before:
            fits.append({"breakpoints": sorted(int(b) for b in breakpoints),
                         "s": time.perf_counter() - t0, "evaluations": evaluations[0] - n_eval,
                         "k1_launches": level_products.launches - k1, "caic": float(out)})
        return out

    def host_stage(fn, key):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            host_s[key] += time.perf_counter() - t0
            return out
        return wrapped

    def counted_loglik(self, params):
        evaluations[0] += 1
        return loglik(self, params)

    def counted_fit(self, *args, **kwargs):
        fit_calls[0] += 1
        return fit(self, *args, **kwargs)

    gard._Evaluator.evaluate = timed_evaluate
    gard.tn93_distance, gard.infer_nj_tree = host_stage(tn93, "tn93"), host_stage(nj, "nj")
    LikelihoodFunction.loglik, LikelihoodFunction.fit = counted_loglik, counted_fit
    torch.cuda.reset_peak_memory_stats()
    level_products.launches = 0
    settings.warmup = True
    try:
        t0 = time.perf_counter()
        run = gard.run(fasta, checkpoint=checkpoint, **options)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        search_fits, first_fit_calls = list(fits), fit_calls[0]
        # resumed from the checkpoint: the baseline is fitted again, nothing else
        fit_calls[0] = 0
        t0 = time.perf_counter()
        resumed = gard.run(fasta, checkpoint=checkpoint, **options)
        resumed_s = time.perf_counter() - t0
        resumed_fit_calls = fit_calls[0]
        launches = level_products.launches
        settings.warmup = False
        # the baseline and the best model fitted to convergence in fp32, the
        # card's precision; then the baseline alone in fp64, whose c-AIC
        # against fp32's is the rounding that the search's 0.01 threshold
        # sees (the fp64 best model went for phase 30's room)
        var_sites = gard._variable_sites(filt)[::stride]
        converged = {}
        for dtype in ("float32", "float64"):
            os.environ["HYPHY_TPU_PRECISION"] = dtype
            del fits[:]
            refit = gard._Evaluator(filt, var_sites, 1e-4, device=DEVICE)
            t0 = time.perf_counter()
            caic = {"baseline": refit.evaluate(())}
            if dtype == "float32":
                caic["best"] = refit.evaluate(run.breakpoints)
                caic["delta"] = caic["baseline"] - caic["best"]
            converged[dtype] = {**caic, "s": time.perf_counter() - t0,
                                "fits": [dict(f) for f in fits]}
    finally:
        settings.warmup = False
        os.environ.pop("HYPHY_TPU_PRECISION", None)
        for (owner, name), original in zip(saved, originals):
            setattr(owner, name, original)
    res = {"total_s": total, "level_products_launches": launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "options": options,
           "variable_sites": n_variable, "host_s": host_s, "fit_calls": first_fit_calls,
           "breakpoints": run.breakpoints, "baseline_caic": run.baseline_caic,
           "best_caic": run.best_caic, "improvements": run.improvements,
           "potential_breakpoints": run.json["potentialBreakpoints"],
           "resumed_s": resumed_s, "resumed_fit_calls": resumed_fit_calls,
           "fits": {"count": len(search_fits),
                    **{key: _eval_stats([f[key] for f in search_fits])
                       for key in ("s", "evaluations", "k1_launches")}},
           "fit_list": search_fits, "converged": converged}
    by_parts = {}
    for f in search_fits:
        row = by_parts.setdefault(str(len(f["breakpoints"]) + 1), [0, 0.0])
        row[0] += 1
        row[1] += f["s"]
    res["fits"]["by_partitions"] = by_parts
    near = [b for b in run.breakpoints if abs(b - (GARD_HALF - 1)) <= GARD_BREAKPOINT_SLACK]
    log(f"[gard] warmup gard.run on {GARD_TAXA} taxa x {2 * GARD_HALF} sites ({n_variable} "
        f"variable), {options}: {total:.2f} s, {len(search_fits)} candidate fits + the baseline "
        f"({first_fit_calls} fits in all), K1 launches {launches} (with the resumed run), peak "
        f"{res['peak_gb']:.2f} GB; "
        f"host TN93 {host_s['tn93']:.3f} s, NJ {host_s['nj']:.3f} s")
    log(f"[gard] per capped candidate fit: s {_rounded(res['fits']['s'])}, evaluations "
        f"{_rounded(res['fits']['evaluations'])}, K1 launches "
        f"{_rounded(res['fits']['k1_launches'])}; by partitions (fits, s) {by_parts}")
    log(f"[gard] breakpoints {run.breakpoints} (planted after site {GARD_HALF}), "
        f"{res['potential_breakpoints']} potential; improvements {run.improvements}; capped "
        f"c-AIC baseline {run.baseline_caic:.4f} best {run.best_caic:.4f}")
    log(f"[gard] resumed from the checkpoint: {resumed_s:.2f} s, {resumed_fit_calls} fit(s), "
        f"breakpoints {resumed.breakpoints}")
    for dtype, row in converged.items():
        best = (f" best {row['best']:.4f}, difference {row['delta']:.4f}" if "best" in row
                else "")
        log(f"[gard] converged {dtype}: c-AIC baseline {row['baseline']:.4f}{best}; fits (s, "
            f"evaluations, K1 launches) "
            f"{[(round(f['s'], 2), f['evaluations'], f['k1_launches']) for f in row['fits']]}")
    res["baseline_fp32_minus_fp64"] = (converged["float32"]["baseline"]
                                       - converged["float64"]["baseline"])
    log(f"[gard] fp32 - fp64 c-AIC of the converged baseline: "
        f"{res['baseline_fp32_minus_fp64']:.4e} (the search's threshold 0.01)")
    check(bool(near), f"GARD: no breakpoint within {GARD_BREAKPOINT_SLACK} of {GARD_HALF}")
    check(run.best_caic < run.baseline_caic, "GARD: the best model is no better than the baseline")
    check(resumed_fit_calls == 1 and resumed.json["totalModelCount"] == 0,
          "GARD: the resumed run fitted candidates")
    check(resumed.breakpoints == run.breakpoints and sorted(resumed.site_support)
          == sorted(run.site_support) and all(abs(resumed.site_support[k] - v) <= 1e-12
                                              for k, v in run.site_support.items()),
          "GARD: the resumed run ends elsewhere")
    check(all(math.isfinite(v) for row in converged.values()
              for k, v in row.items() if k in ("baseline", "best")),
          "GARD: a converged fit is not finite")
    check(converged["float32"]["best"] < converged["float32"]["baseline"],
          "GARD: converged, the best model is no better than the baseline")
    check(launches > 0, "GARD launched no level_products kernel")
    return res


def _engine_binary(torch, newick: str, tmp: str) -> dict:
    """(a) Binary, K1 at 2 states: BINARY_CHARS characters simulated along
    the bench tree, the fit capped (``warmup``) in fp32, then the lnL at the
    fitted point on the card in fp32 and fp64 and on the host in fp64."""
    import numpy as np

    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.data.alignment import read_alignment
    from hyphy_tpu_torch.data.filter import DataFilter
    from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
    from hyphy_tpu_torch.models.binary import Binary
    from hyphy_tpu_torch.ops.level_products import level_products
    from hyphy_tpu_torch.tree.topology import Tree
    from hyphy_tpu_torch.utils.simulate import simulate_states

    t0 = time.perf_counter()
    sim_tree = Tree.from_newick(newick)
    lengths = np.maximum(np.asarray(sim_tree.input_lengths[:-1]), 1e-6)
    truth = Binary(BINARY_FREQS, device="cpu")
    p = truth.build({"t": torch.as_tensor(lengths)}, sim_tree.n_branches).p_matrices.numpy()
    states = simulate_states(sim_tree, p, np.asarray(BINARY_FREQS), BINARY_CHARS,
                             np.random.default_rng(SEED))
    chars = np.array(["0", "1"])[states[: sim_tree.n_leaves]]
    fasta = os.path.join(tmp, "binary.fasta")
    _write_fasta(fasta, sim_tree.names[: sim_tree.n_leaves], ["".join(row) for row in chars])
    filt = DataFilter.from_alignment(read_alignment(fasta), "binary")
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    freqs = filt.harvest_frequencies(1, 1, False)[:, 0]
    input_s = time.perf_counter() - t0
    part = [Partition(filt, tree, Binary(freqs, device=DEVICE))]
    lf32 = LikelihoodFunction(part, device=DEVICE)
    lf64 = LikelihoodFunction(part, dtype=torch.float64, device=DEVICE)
    lf_host = LikelihoodFunction([Partition(filt, tree, Binary(freqs, device="cpu"))],
                                 device="cpu")
    settings.warmup = True
    try:
        t0 = time.perf_counter()
        fit = lf32.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        settings.warmup = False
    params = {k: v.detach() for k, v in fit.params.items()}
    with torch.no_grad():
        before = level_products.launches
        site32 = lf32.site_log_likelihoods(params)[0]
        k1_per_value = level_products.launches - before
        site64 = lf64.site_log_likelihoods(params)[0]
        site_host = lf_host.site_log_likelihoods({k: v.cpu() for k, v in params.items()})[0]
    w = np.asarray(filt.pattern_weights)
    lnl = {"fp32": float(site32.double().cpu().numpy() @ w),
           "fp64": float(site64.cpu().numpy() @ w), "host_fp64": float(site_host.numpy() @ w)}
    host_rel = abs(lnl["fp64"] - lnl["host_fp64"]) / abs(lnl["host_fp64"])
    fp32_site = float((site32.double() - site64).abs().max())

    def value():
        with torch.no_grad():
            return lf32.loglik(params)

    def value_grad():
        q = {k: v.clone().requires_grad_() for k, v in params.items()}
        lf32.loglik(q).backward()

    widest = max(len(lv) for lv in tree.levels())
    res = {"characters": BINARY_CHARS, "patterns": int(filt.n_patterns), "input_s": input_s,
           "fit_s": fit_s, "fit_iterations": fit.n_iterations, "lnl": lnl,
           "host_rel": host_rel, "fp32_max_site_diff": fp32_site,
           "k1_per_value": k1_per_value, "value_ms": wall_ms(torch, value, 5),
           "value_grad_ms": wall_ms(torch, value_grad, 5),
           "widest_level": [widest, 2, int(filt.n_patterns), 2]}
    log(f"[engine] (a) Binary on {N_TAXA} taxa x {BINARY_CHARS} characters "
        f"({res['patterns']} patterns; input {input_s:.2f} s on the host): capped fit "
        f"{fit_s:.2f} s ({fit.n_iterations} iterations), lnL fp32 {lnl['fp32']:.6f} fp64 "
        f"{lnl['fp64']:.8f} host fp64 {lnl['host_fp64']:.8f} (card vs host rel "
        f"{host_rel:.3e}, bound {ENGINE_HOST_REL_BOUND}); fp32 vs fp64 max per pattern "
        f"{fp32_site:.3e} (bound {ENGINE_FP32_SITE_BOUND}); K1 per value {k1_per_value} at "
        f"widest {res['widest_level']}; ms per value {_rounded_list(res['value_ms'])}, "
        f"value+gradient {_rounded_list(res['value_grad_ms'])}")
    check(host_rel <= ENGINE_HOST_REL_BOUND, "Binary: card fp64 lnL far from the host's")
    check(fp32_site <= ENGINE_FP32_SITE_BOUND, "Binary: fp32 site lnL far from fp64")
    check(k1_per_value == len(tree.levels()), "Binary: not one K1 launch per level")
    return res


def _rounded_list(values) -> list:
    return [round(v, 3) for v in values]


def _root_to_tip(tree, t):
    """Every leaf's path length to the root under branch values ``t``."""
    import numpy as np

    dist = np.zeros(tree.n_nodes)
    for nd in sorted(range(tree.n_nodes), key=lambda n: -n):     # parents first
        if nd != tree.root:
            dist[nd] = dist[tree.parent[nd]] + t[nd]
    return dist[: tree.n_leaves]


def _engine_constraints(torch, fasta: str, newick: str) -> dict:
    """(b) Constraints: bench.py's alignment read as nucleotides under GTR,
    fitted (capped) with theta_AC := R theta_AT and with a molecular clock
    on t; each constraint holds on the fitted parameters, and the card's
    fp64 lnL at them equals the host's."""
    import numpy as np

    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.data.alignment import read_alignment
    from hyphy_tpu_torch.data.filter import DataFilter
    from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
    from hyphy_tpu_torch.models.constraints import MolecularClock, Proportional
    from hyphy_tpu_torch.models.dna import GTR
    from hyphy_tpu_torch.tree.topology import Tree

    filt = DataFilter.from_alignment(read_alignment(fasta), "nucleotide")
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    freqs = filt.harvest_frequencies(1, 1, False)[:, 0]
    lf32 = LikelihoodFunction([Partition(filt, tree, GTR(freqs, device=DEVICE))], device=DEVICE)
    lf64 = LikelihoodFunction(lf32.partitions, dtype=torch.float64, device=DEVICE)
    lf_host = LikelihoodFunction([Partition(filt, tree, GTR(freqs, device="cpu"))], device="cpu")
    res = {"patterns": int(filt.n_patterns)}
    for name, con in (("proportional", Proportional("theta_AC", "theta_AT", ratio_key="R")),
                      ("clock", MolecularClock(tree, "t"))):
        settings.warmup = True
        try:
            t0 = time.perf_counter()
            fit = lf32.fit(constraints=[con])
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        finally:
            settings.warmup = False
        params = {k: v.detach() for k, v in fit.params.items()}
        with torch.no_grad():
            card = float(lf64.loglik(params))
        host = float(lf_host.loglik({k: v.cpu() for k, v in params.items()}))
        row = {"fit_s": fit_s, "iterations": fit.n_iterations, "free": fit.n_free_parameters,
               "lnl_fit_fp32": fit.loglik, "lnl_fp64": card, "lnl_host_fp64": host,
               "host_rel": abs(card - host) / abs(host)}
        if name == "proportional":
            ac, r, at = (float(params[k]) for k in ("theta_AC", "R", "theta_AT"))
            row["exact"] = ac == r * at
            check(row["exact"], "Proportional: theta_AC is not R * theta_AT")
        else:
            t = params["t"].cpu().numpy()
            paths = _root_to_tip(tree, t)
            height = float(params["t_clock_height"])
            row["path_rel"] = float(np.abs(paths - height).max() / height)
            row["min_t"] = float(t.min())
            check(row["min_t"] >= 0 and row["path_rel"] <= CLOCK_PATH_REL_BOUND,
                  f"MolecularClock: root-to-tip paths differ by {row['path_rel']:.3e}")
        log(f"[engine] (b) GTR with {name} on {N_TAXA} taxa x {3 * N_CODONS} nucleotides "
            f"({res['patterns']} patterns): capped fit {fit_s:.2f} s ({fit.n_iterations} "
            f"iterations, {fit.n_free_parameters} free), lnL fp32 {fit.loglik:.6f}; at the fit "
            f"card fp64 {card:.8f} host fp64 {host:.8f} (rel {row['host_rel']:.3e}); "
            + (f"theta_AC == R theta_AT {row['exact']}" if name == "proportional" else
               f"root-to-tip paths within {row['path_rel']:.3e} of the height, min t "
               f"{row['min_t']:.3e}"))
        check(row["host_rel"] <= ENGINE_HOST_REL_BOUND,
              f"{name}: card fp64 lnL far from the host's")
        res[name] = row
    return res


def _engine_codon(torch, aln, newick: str) -> dict:
    """(c) MG94xREV (F1x4) and MG94xREVLocal (CF3x4) on bench.py's workload,
    fitted capped in fp32: ms per value and value+gradient, K1 launches per
    value, the propagators' ms (fp32 Taylor; fp64 spectral: one eigh per
    branch for the local model), and fp32 against fp64 per pattern at the
    fit.  Returns the MG94xREV model, fit and filter for (d)-(f)."""
    import numpy as np

    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.data.filter import DataFilter
    from hyphy_tpu_torch.data.genetic_code import GeneticCode
    from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
    from hyphy_tpu_torch.models import frequencies as freq_mod
    from hyphy_tpu_torch.models.codon import MG94xREV, MG94xREVLocal
    from hyphy_tpu_torch.ops.level_products import level_products
    from hyphy_tpu_torch.tree.topology import Tree

    gc = GeneticCode("Universal")
    filt = DataFilter.from_alignment(aln, "codon", genetic_code=gc)
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    nb = tree.n_branches
    res, keep = {}, {}
    for name, cls, freqs in (("MG94xREV", MG94xREV, freq_mod.f1x4(filt, gc)),
                             ("MG94xREVLocal", MG94xREVLocal,
                              freq_mod.cf3x4(filt, gc, device=DEVICE))):
        model = cls(gc, *freqs, device=DEVICE)
        part = [Partition(filt, tree, model)]
        lf32 = LikelihoodFunction(part, device=DEVICE)
        lf64 = LikelihoodFunction(part, dtype=torch.float64, device=DEVICE)
        settings.warmup = True
        try:
            t0 = time.perf_counter()
            fit = lf32.fit()
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        finally:
            settings.warmup = False
        params = {k: v.detach() for k, v in fit.params.items()}
        p32 = {k: v.float() for k, v in params.items()}

        def value():
            with torch.no_grad():
                return lf32.loglik(params)

        def value_grad():
            q = {k: v.clone().requires_grad_() for k, v in params.items()}
            lf32.loglik(q).backward()

        def build32():
            with torch.no_grad():
                return model.build(p32, nb)

        def build64():
            with torch.no_grad():
                return model.build(params, nb)

        before = level_products.launches
        value()
        k1_per_value = level_products.launches - before
        row = {"fit_s": fit_s, "iterations": fit.n_iterations, "free": fit.n_free_parameters,
               "lnl_fit_fp32": fit.loglik, "k1_per_value": k1_per_value,
               "value_ms": wall_ms(torch, value, 5), "value_grad_ms": wall_ms(torch, value_grad, 3),
               "propagators_fp32_ms": wall_ms(torch, build32, 3),
               "propagators_fp64_ms": wall_ms(torch, build64, 1)}
        with torch.no_grad():
            site32 = lf32.site_log_likelihoods(params)[0].double()
            site64 = lf64.site_log_likelihoods(params)[0]
        row["fp32_max_site_diff"] = float((site32 - site64).abs().max())
        row["lnl_fp64"] = float(site64.cpu().numpy() @ np.asarray(filt.pattern_weights))
        log(f"[engine] (c) {name} ({'F1x4' if name == 'MG94xREV' else 'CF3x4'}, "
            f"{fit.n_free_parameters} free parameters) on {N_TAXA} x {N_CODONS} codons: capped "
            f"fit {fit_s:.2f} s ({fit.n_iterations} iterations), lnL fp32 {fit.loglik:.6f}, fp64 "
            f"{row['lnl_fp64']:.6f}; fp32 vs fp64 max per pattern {row['fp32_max_site_diff']:.3e} "
            f"(bound {ENGINE_FP32_SITE_BOUND}); ms per value {_rounded_list(row['value_ms'])}, "
            f"value+gradient {_rounded_list(row['value_grad_ms'])}; K1 per value {k1_per_value}; "
            f"propagators ({nb} branches) fp32 Taylor {_rounded_list(row['propagators_fp32_ms'])} "
            f"ms, fp64 spectral {_rounded_list(row['propagators_fp64_ms'])} ms")
        check(math.isfinite(fit.loglik) and math.isfinite(row["lnl_fp64"]),
              f"{name}: a non-finite lnL")
        check(row["fp32_max_site_diff"] <= ENGINE_FP32_SITE_BOUND,
              f"{name}: fp32 site lnL far from fp64")
        check(k1_per_value == len(tree.levels()), f"{name}: not one K1 launch per level")
        res[name] = row
        if name == "MG94xREV":
            keep = dict(model=model, params=params, filt=filt, tree=tree, lf64=lf64)
        del lf32, lf64, part
        torch.cuda.empty_cache()
    return res, keep


def _engine_uncertainty(torch, keep) -> dict:
    """(d) covariance_matrix over the five thetas and omega at the MG94xREV
    fit in fp64 (its inverse, the negative Hessian, held to central
    differences of the autograd gradient), then profile_ci of omega."""
    import numpy as np

    lf64 = keep["lf64"]
    params = {k: v.double() for k, v in keep["params"].items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cov, labels = lf64.covariance_matrix(params, keys=ENGINE_COV_KEYS)
    cov_s = time.perf_counter() - t0
    hess = -np.linalg.pinv(cov)
    x0 = np.array([float(params[k]) for k in ENGINE_COV_KEYS])

    def grad_at(x):
        leaves = [torch.tensor(v, dtype=torch.float64, device=DEVICE, requires_grad=True)
                  for v in x]
        p = dict(params)
        p.update(zip(ENGINE_COV_KEYS, leaves))
        return np.array([float(g) for g in torch.autograd.grad(lf64.loglik(p), leaves)])

    t0 = time.perf_counter()
    fd = np.zeros((len(x0), len(x0)))
    for i in range(len(x0)):
        h = ENGINE_FD_STEP * max(abs(x0[i]), 1e-3)
        e = np.zeros(len(x0))
        e[i] = h
        fd[i] = (grad_at(x0 + e) - grad_at(x0 - e)) / (2 * h)
    fd_s = time.perf_counter() - t0
    scale = np.abs(fd).max()
    sym = float(np.abs(cov - cov.T).max() / np.abs(cov).max())
    fd_rel = float(np.abs(hess - fd).max() / scale)
    with torch.no_grad():
        lnl = float(lf64.loglik(params))
    calls = [0]
    original = lf64.loglik

    def counted(p):
        calls[0] += 1
        return original(p)

    lf64.loglik = counted
    try:
        t0 = time.perf_counter()
        lo, hi = lf64.profile_ci(params, "omega", lnl)
        ci_s = time.perf_counter() - t0
    finally:
        del lf64.loglik
    omega = float(params["omega"])
    res = {"labels": labels, "covariance_s": cov_s, "fd_s": fd_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "hessian_diag": np.diag(hess).tolist(), "variances": np.diag(cov).tolist(),
           "cov_symmetry_rel": sym, "hessian_vs_fd_rel": fd_rel, "lnl_fp64": lnl,
           "omega": omega, "omega_ci": [lo, hi], "ci_s": ci_s, "ci_evaluations": calls[0]}
    log(f"[engine] (d) covariance of {labels} at the MG94xREV fit (fp64): {cov_s:.2f} s, "
        f"peak {res['peak_gb']:.2f} GB; symmetric to {sym:.3e} (bound {HESSIAN_SYM_BOUND}); "
        f"-inverse vs central differences of the gradient {fd_rel:.3e} of the largest entry "
        f"{scale:.4e} (bound {HESSIAN_FD_BOUND}; {fd_s:.2f} s); variances "
        f"{[f'{v:.3e}' for v in res['variances']]}")
    log(f"[engine] (d) profile CI of omega: [{lo:.6f}, {hi:.6f}] around {omega:.6f}, "
        f"{calls[0]} loglik evaluations, {ci_s:.2f} s")
    check(bool(np.isfinite(cov).all()) and bool(np.isfinite(hess).all()),
          "covariance: non-finite entries")
    check(sym <= HESSIAN_SYM_BOUND, "covariance: not symmetric")
    check(fd_rel <= HESSIAN_FD_BOUND, "covariance: Hessian differs from central differences")
    check(lo <= omega <= hi, "profile CI without LB <= MLE <= UB")
    return res


def _engine_marginal(torch, keep) -> dict:
    """(e) marginal_posteriors of every internal node at the MG94xREV fit in
    fp64 on the card: rows summing to 1, and the first patterns against
    the host's on the same propagators."""
    from hyphy_tpu_torch.ops import ancestral, pruning

    model, filt, tree = keep["model"], keep["filt"], keep["tree"]
    params = {k: v.double() for k, v in keep["params"].items()}
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        p = model.build(params, tree.n_branches).p_matrices
        leaves = torch.as_tensor(filt.leaf_partials(), device=DEVICE).double()
        freqs = model.frequencies.double()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        post = ancestral.marginal_posteriors(p, leaves, freqs,
                                             pruning.build_pruning_data(tree, DEVICE))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        row_err = float((post.sum(-1) - 1.0).abs().max())
        n = MARGINAL_HOST_PATTERNS
        host = ancestral.marginal_posteriors(p.cpu(), leaves[:, :n].cpu(), freqs.cpu(),
                                             pruning.build_pruning_data(tree, "cpu"))
        host_diff = float((post[:, :n].cpu() - host).abs().max())
    res = {"shape": list(post.shape), "card_s": card_s, "row_sum_err": row_err,
           "host_max_diff": host_diff, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[engine] (e) marginal posteriors {res['shape']} fp64: {card_s:.2f} s, peak "
        f"{res['peak_gb']:.2f} GB; rows sum to 1 within {row_err:.3e} (bound "
        f"{POSTERIOR_ROW_BOUND}); card vs host on {n} patterns {host_diff:.3e} (bound "
        f"{MARGINAL_HOST_BOUND})")
    check(row_err <= POSTERIOR_ROW_BOUND, "marginal posteriors: rows do not sum to 1")
    check(host_diff <= MARGINAL_HOST_BOUND, "marginal posteriors: card differs from host")
    return res


def _engine_small(torch, keep, tmp: str) -> dict:
    """(f) The dense per-site route against the Taylor per-site route;
    expm and transition_matrix against scipy; the discretized gamma card vs
    host; the native aligners against their Python mirrors; native TN93
    against NumPy TN93 on GARD's input."""
    import numpy as np
    import scipy.linalg as sla

    from hyphy_tpu_torch import align
    from hyphy_tpu_torch.data.alignment import read_alignment
    from hyphy_tpu_torch.data.filter import DataFilter
    from hyphy_tpu_torch.methods import gard
    from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
    from hyphy_tpu_torch.models.rate_variation import discretized_gamma
    from hyphy_tpu_torch.ops import expm, pruning

    res = {}
    model, filt, tree = keep["model"], keep["filt"], keep["tree"]
    params = {k: v.double() for k, v in keep["params"].items()}
    with torch.no_grad():
        q_syn, q_non = model.basis_matrices(params)
        q = fill_diagonal_from_rows(q_syn + params["omega"] * q_non)
        t = params["t"]
        leaves = torch.as_tensor(filt.leaf_partials()[:, :DENSE_SITES], device=DEVICE)
        leaves = leaves.double().transpose(0, 1).contiguous()                  # [N, leaves, S]
        data = pruning.build_pruning_data(tree, DEVICE)
        freqs = model.frequencies.double()
        t0 = time.perf_counter()
        p = expm.transition_matrix(q.expand(len(t), -1, -1), t)
        dense = pruning.single_site_log_likelihood_dense(p, leaves, freqs, data)
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
        qn, m2p, r, j = expm.taylor_action_factors(q.expand(DENSE_SITES, 1, -1, -1), t)
        group = torch.zeros(len(t), dtype=torch.int64, device=DEVICE)
        taylor = pruning.single_site_log_likelihood_taylor(
            qn, m2p, r[:, 0], j[:, 0], group, expm.taylor_action_terms(torch.float64),
            leaves, freqs, data)
    res["dense_vs_taylor"] = float((dense - taylor).abs().max())
    res["dense_s"] = dense_s
    rng = np.random.default_rng(SEED)
    gens = rng.exponential(1.0, size=(EXPM_GENERATORS, 61, 61)) * rng.uniform(
        0.0, 1.0, size=(EXPM_GENERATORS, 61, 61)) ** 3
    gens *= 10.0 ** rng.uniform(-3, 1, size=(EXPM_GENERATORS, 1, 1))
    idx = np.arange(61)
    gens[:, idx, idx] = 0.0
    gens[:, idx, idx] = -gens.sum(-1)
    times = rng.uniform(0.01, 2.0, size=EXPM_GENERATORS)
    with torch.no_grad():
        g_card = torch.as_tensor(gens, device=DEVICE)
        e_card = expm.expm(g_card).cpu().numpy()
        p_card = expm.transition_matrix(g_card, torch.as_tensor(times, device=DEVICE)).cpu().numpy()
    res["expm_vs_scipy"] = float(np.abs(e_card - np.stack([sla.expm(g) for g in gens])).max())
    res["transition_vs_scipy"] = float(np.abs(
        p_card - np.stack([sla.expm(g * tt) for g, tt in zip(gens, times)])).max())
    gamma = []
    for alpha in GAMMA_ALPHAS:
        row = []
        for device in (DEVICE, "cpu"):
            a = torch.tensor(alpha, dtype=torch.float64, device=device, requires_grad=True)
            rates, _ = discretized_gamma(a, 4)
            grad = torch.autograd.grad((rates * torch.arange(1, 5, device=device)).sum(), a)[0]
            row.append((rates.detach().cpu().numpy(), float(grad)))
        gamma.append(max(float(np.abs(row[0][0] - row[1][0]).max()),
                         abs(row[0][1] - row[1][1]) / max(abs(row[1][1]), 1e-300)))
    res["gamma_card_vs_host"] = max(gamma)
    ref, qry = "ATGAAACCCGGGTTTCAGCTAGGT", "ATGAACCCGGGTTTTCAGCTGGT"
    res["align_codon"] = align.align_codon(ref, qry)
    res["align_sequences"] = align.align_sequences("GGGGACGTACGTGGGG", "ACGTTACGT")
    aligners_equal = (res["align_codon"] == align.align_codon(ref, qry, use_native=False)
                      and res["align_sequences"] == align.align_sequences(
                          "GGGGACGTACGTGGGG", "ACGTTACGT", use_native=False))
    gfilt = DataFilter.from_alignment(read_alignment(_recombinant_alignment(tmp)), "nucleotide")
    t0 = time.perf_counter()
    native_d = gard.tn93_distance(gfilt)
    res["tn93_native_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    numpy_d = gard.tn93_distance(gfilt, use_native=False)
    res["tn93_numpy_s"] = time.perf_counter() - t0
    res["tn93_diff"] = float(np.abs(native_d - numpy_d).max())
    log(f"[engine] (f) dense per-site route vs Taylor route on {DENSE_SITES} sites (fp64): "
        f"{res['dense_vs_taylor']:.3e} (bound {DENSE_BOUND}; dense {dense_s:.3f} s with the "
        f"propagators); expm / transition_matrix vs scipy on {EXPM_GENERATORS} 61 x 61 "
        f"generators {res['expm_vs_scipy']:.3e} / {res['transition_vs_scipy']:.3e} (bound "
        f"{EXPM_BOUND}); discretized gamma card vs host {res['gamma_card_vs_host']:.3e} "
        f"(bound {GAMMA_BOUND}); native aligners equal to their mirrors {aligners_equal} "
        f"(codon {res['align_codon']}); TN93 native vs NumPy {res['tn93_diff']:.3e} (bound "
        f"{TN93_BOUND}; {res['tn93_native_s']:.4f} s against {res['tn93_numpy_s']:.4f} s)")
    check(res["dense_vs_taylor"] <= DENSE_BOUND, "dense per-site route differs from Taylor")
    check(max(res["expm_vs_scipy"], res["transition_vs_scipy"]) <= EXPM_BOUND,
          "expm differs from scipy")
    check(res["gamma_card_vs_host"] <= GAMMA_BOUND, "discretized gamma: card differs from host")
    check(aligners_equal, "native aligners differ from their Python mirrors")
    check(res["tn93_diff"] <= TN93_BOUND, "native TN93 differs from NumPy TN93")
    return res


def phase_engine(torch, aln, fasta: str, newick: str, tmp: str) -> dict:
    """Phase 29, the rest of the engine at full width: (a) the Binary model
    (K1 at 2 states), (b) GTR under constraints, (c) MG94xREV and
    MG94xREVLocal, (d) the covariance and a profile CI, (e) the marginal
    ancestral posteriors, (f) the small checks; K1 launches counted from 0
    around (a)-(e)."""
    from hyphy_tpu_torch.ops.level_products import level_products

    res, stages = {}, {}
    level_products.launches = 0

    def stage(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    res["binary"] = stage("binary", _engine_binary, torch, newick, tmp)
    res["constraints"] = stage("constraints", _engine_constraints, torch, fasta, newick)
    res["codon"], keep = stage("codon", _engine_codon, torch, aln, newick)
    res["uncertainty"] = stage("uncertainty", _engine_uncertainty, torch, keep)
    res["marginal"] = stage("marginal", _engine_marginal, torch, keep)
    res["level_products_launches"] = level_products.launches
    res["small"] = stage("small", _engine_small, torch, keep, tmp)
    res["stages_s"] = stages
    log(f"[engine] stages, s: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f"; K1 launches {res['level_products_launches']}")
    check(res["level_products_launches"] > 0, "the engine phase launched no K1")
    return res


def _mesh_launch_devices(torch):
    """K1's launches counted per device while the returned dict is live
    (the wrapper's own count is one total); ``restore()`` ends it."""
    from hyphy_tpu_torch.ops import level_products as lp_mod

    original, lock = lp_mod._launch, threading.Lock()
    seen = {}

    def launch(cc, cp):
        # a sharded per-site solve launches from one thread per block
        with lock:
            seen[str(cc.device)] = seen.get(str(cc.device), 0) + 1
        return original(cc, cp)

    lp_mod._launch = launch
    seen["restore"] = lambda: setattr(lp_mod, "_launch", original)
    return seen


def _mesh_overlap(torch, fn, path: str, warm: bool = True) -> dict:
    """One run of ``fn`` under torch.profiler on a mesh of distinct cards
    (after a first run unless ``warm`` is false): per card its kernels'
    summed time and the window from its first kernel's start to its last
    one's end, and how much of the windows overlap (the summed windows over
    the span of all of them: 1 when the cards ran one after another, up to
    the card count when they ran at once)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cards = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        c = cards.setdefault(e.device_index, {"busy_us": 0.0, "start": e.time_range.start,
                                              "end": e.time_range.end, "kernels": 0})
        c["busy_us"] += e.time_range.end - e.time_range.start
        c["start"] = min(c["start"], e.time_range.start)
        c["end"] = max(c["end"], e.time_range.end)
        c["kernels"] += 1
    with open(path, "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    if not cards:
        return {"wall_ms": wall, "cards": {}, "overlap": None}
    span = max(c["end"] for c in cards.values()) - min(c["start"] for c in cards.values())
    windows = sum(c["end"] - c["start"] for c in cards.values())
    return {"wall_ms": wall,
            "cards": {str(k): {"busy_ms": c["busy_us"] / 1e3, "kernels": c["kernels"],
                               "window_ms": (c["end"] - c["start"]) / 1e3}
                      for k, c in sorted(cards.items())},
            "overlap": windows / span if span > 0 else None}


def _mesh_compare(torch, f0, fm, name: str, dtype_name: str, grad_keys=None,
                  hold_lnl: bool = True) -> dict:
    """``f()`` -> (lnL tensor, site vector tensor or None, {key: grad}) of the
    unsharded (``f0``) and the sharded (``fm``) evaluation, held to phase
    30's bounds; the gradient over ``grad_keys`` (default: every key), the
    others' relative differences reported per key; the lnL reported only
    unless ``hold_lnl``."""
    import numpy as np

    v0, s0, g0 = f0()
    vm, sm, gm = fm()
    out_keys = {}
    if grad_keys is not None:
        for k in sorted(set(g0) - set(grad_keys)):
            a, b = gm[k].double().cpu().numpy(), g0[k].double().cpu().numpy()
            out_keys[k] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        g0 = {k: g0[k] for k in grad_keys}
    v0, vm = float(v0), float(vm)
    out = {"lnl": v0, "lnl_sharded": vm, "lnl_rel": abs(vm - v0) / abs(v0)}
    if s0 is not None:
        s0, sm = s0.double().cpu().numpy(), sm.double().cpu().numpy()
        check(sm.shape == s0.shape, f"{name}: sharded site vector {sm.shape}, not {s0.shape}")
        out["site_rel"] = float((np.abs(sm - s0) / np.abs(s0)).max())
    out["grad_rel"] = 0.0
    if g0:
        a = np.concatenate([gm[k].double().cpu().numpy().ravel() for k in sorted(g0)])
        b = np.concatenate([g0[k].double().cpu().numpy().ravel() for k in sorted(g0)])
        out["grad_rel"] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    out["grad_keys"] = sorted(g0)
    if out_keys:
        out["grad_rel_unbounded_keys"] = out_keys
    lnl_bound = f"{MESH_LNL_REL:.0e}" if hold_lnl else "none"
    log(f"[mesh] {name} {dtype_name}: lnL {v0:.8f} sharded {vm:.8f} (rel "
        f"{out['lnl_rel']:.3e}, bound {lnl_bound}); site vector rel "
        f"{out.get('site_rel', float('nan')):.3e} (bound {MESH_SITE_REL[dtype_name]:.0e}); "
        f"gradient rel over {out['grad_keys']} {out['grad_rel']:.3e} (bound "
        f"{MESH_GRAD_REL[dtype_name]:.0e})"
        + (f"; not bounded here, rel per key {out_keys}" if out_keys else ""))
    check(math.isfinite(vm) and (out["lnl_rel"] <= MESH_LNL_REL or not hold_lnl),
          f"{name} {dtype_name}: sharded lnL off the unsharded")
    check(out.get("site_rel", 0.0) <= MESH_SITE_REL[dtype_name],
          f"{name} {dtype_name}: sharded site vector off the unsharded")
    check(out["grad_rel"] <= MESH_GRAD_REL[dtype_name],
          f"{name} {dtype_name}: sharded gradient off the unsharded")
    return out


def _lf_value_grad(torch, lf, params):
    def run():
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        value = lf.loglik(p)
        value.backward()
        with torch.no_grad():
            (site,) = lf.site_log_likelihoods(params)
        return value.detach(), site, {k: p[k].grad for k in p}
    return run


def _mesh_gene(torch, aln, newick: str, mesh, distinct: bool) -> dict:
    """(a): MG94xREV at bench.py's point, sharded against unsharded, with
    times, K1 launches per value on each device and the peak per device."""
    import numpy as np

    from hyphy_tpu_torch.convert import params_from_numpy
    from hyphy_tpu_torch.data.filter import DataFilter
    from hyphy_tpu_torch.data.genetic_code import GeneticCode
    from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
    from hyphy_tpu_torch.models import frequencies as freq_mod
    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.models.codon import MG94xREVPartitionedOmega
    from hyphy_tpu_torch.ops import pruning
    from hyphy_tpu_torch.ops.level_products import level_products
    from hyphy_tpu_torch.parallel.mesh import data_mesh
    from hyphy_tpu_torch.tree.topology import Tree

    gc = GeneticCode("Universal")
    filt = DataFilter.from_alignment(aln, "codon", genetic_code=gc)
    leaves = filt.leaf_partials()
    filt.leaf_partials = lambda: leaves      # made once for the four functions below
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    corners, codon_freqs = freq_mod.f3x4(filt, gc)
    nb = tree.n_branches
    model = MG94xREVPartitionedOmega(
        gc, corners, codon_freqs,
        nuc_lengths=np.maximum(np.abs(np.asarray(tree.input_lengths[:-1])), 1e-3),
        branch_groups=np.zeros(nb, dtype=np.int32), n_groups=1, free_lengths=True,
        device=DEVICE)
    point = {k: np.full(s.shape, s.init, np.float64)
             for k, s in model.parameter_specs(nb).items()}
    point["alpha"] = model.nuc_lengths.cpu().numpy()
    params = params_from_numpy(point, DEVICE)
    conditioned = dict(params, **params_from_numpy(
        dict({f"theta_{p}": np.float64(v) for p, v in
              zip(("AC", "AT", "CG", "CT", "GT"), (0.4, 0.3, 0.6, 1.4, 0.5))},
             alpha=np.maximum(point["alpha"], 0.05), omega=np.array([0.3])), DEVICE))
    cards = sorted({str(d) for d in data_mesh(mesh)})
    depth = len(tree.levels())
    res = {"patterns": filt.n_patterns, "depth": depth}
    pdata = pruning.build_pruning_data(tree, DEVICE)
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        part = [Partition(filt, tree, model)]
        lf0 = LikelihoodFunction(part, dtype=dtype, device=DEVICE, mesh=None)
        lfm = LikelihoodFunction(part, dtype=dtype, device=DEVICE, mesh=mesh)
        # the automatic mesh: this gene fits on one card, so it stays there
        # whatever the host's card count
        saved = settings.mesh
        settings.mesh = None
        try:
            auto = LikelihoodFunction(part, dtype=dtype, device=DEVICE).mesh
        finally:
            settings.mesh = saved
        check(auto is None, f"the automatic mesh split a gene that fits on one card: {auto}")
        estimate = pruning.gene_bytes(pdata, filt.n_patterns, 61, dtype.itemsize) / 1e9
        # the fp64 route's gradient is ill-conditioned in the keys that pass
        # through its eigh backward (the thetas, omega), which divides by
        # eigenvalue gaps: the blocks' summation order (1e-16) shows there at
        # 1e-9 relative on a 12-taxon CPU input at omega 0.3 and at 1e-6 to
        # 5e-6 at bench.py's point on an H100, with lnL and site vectors
        # bit-equal; branches down to 1e-3 add the cancellations of ROADMAP
        # 3.5 (the alpha gradient 3.1e-9 there).  So the gradient is
        # reported at bench.py's point and held at a point of distinct
        # thetas and branches of at least 0.05, in fp64 over the branch
        # lengths (no eigh on their path), in fp32 (Taylor) over every key;
        # the site vector bounds the value there
        row = _mesh_compare(torch, _lf_value_grad(torch, lf0, params),
                            _lf_value_grad(torch, lfm, params), "MG94xREV", name,
                            grad_keys=[])
        row["conditioned"] = _mesh_compare(
            torch, _lf_value_grad(torch, lf0, conditioned),
            _lf_value_grad(torch, lfm, conditioned), "MG94xREV, conditioned point", name,
            grad_keys=["alpha"] if dtype == torch.float64 else None, hold_lnl=False)
        seen = _mesh_launch_devices(torch)
        try:
            before = level_products.launches
            with torch.no_grad():
                lfm.loglik(params)
            torch.cuda.synchronize()
            row["k1_per_value"] = level_products.launches - before
        finally:
            seen.pop("restore")()
        row["k1_per_value_by_device"] = dict(seen)
        check(row["k1_per_value"] == depth * len(mesh),
              f"a sharded value launched K1 {row['k1_per_value']} times, not {depth} per shard")
        check(sorted(seen) == cards, f"K1 launched on {sorted(seen)}, the mesh holds {cards}")
        for tag, lf in (("unsharded", lf0), ("sharded", lfm)):
            def value(lf=lf):
                with torch.no_grad():
                    return lf.loglik(params)
            row[f"{tag}_value_ms"] = _eval_stats(wall_ms(torch, value, MESH_REPS))
            row[f"{tag}_value_grad_ms"] = _eval_stats(
                wall_ms(torch, _lf_value_grad(torch, lf, params), MESH_REPS))
            for dev in cards:
                torch.cuda.reset_peak_memory_stats(dev)
            _lf_value_grad(torch, lf, params)()
            torch.cuda.synchronize()
            row[f"{tag}_peak_gb"] = {dev: torch.cuda.max_memory_allocated(dev) / 1e9
                                     for dev in cards}
        row["auto_mesh"] = None
        row["gene_bytes_estimate_gb"] = estimate
        if distinct:
            for what, fn in (("value", lambda: lfm.loglik(params)),
                             ("value_grad", _lf_value_grad(torch, lfm, params))):
                ov = _mesh_overlap(torch, fn, os.path.join(
                    "chiprun_out", f"profile_mesh_{name}_{what}.txt"))
                row[f"overlap_{what}"] = ov
                log(f"[mesh] MG94xREV {name} sharded {what} profiled over the cards: wall "
                    f"{ov['wall_ms']:.3f} ms, per card {ov['cards']}, overlap {ov['overlap']}")
        log(f"[mesh] MG94xREV {name}: ms per value unsharded {row['unsharded_value_ms']}, "
            f"sharded {row['sharded_value_ms']}; per value+gradient unsharded "
            f"{row['unsharded_value_grad_ms']}, sharded {row['sharded_value_grad_ms']}; "
            f"K1 per sharded value {row['k1_per_value']} {row['k1_per_value_by_device']}; "
            f"peak GB unsharded {row['unsharded_peak_gb']}, sharded {row['sharded_peak_gb']}; "
            f"the automatic mesh: none (gene_bytes {estimate:.3f} GB)")
        res[name] = row
        del lf0, lfm
        torch.cuda.empty_cache()
    return res


def _mesh_small_input(tmp: str):
    from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment

    aln = synthetic_codon_alignment(MESH_SMALL_TAXA, MESH_SMALL_CODONS, seed=SEED)
    newick = random_tree_newick(MESH_SMALL_TAXA, seed=SEED)
    fasta = os.path.join(tmp, "mesh.fasta")
    _write_fasta(fasta, aln.names, aln.sequences)
    return aln, newick, fasta


def _mesh_mixed(torch, aln, newick: str) -> dict:
    """(b): the mesh (the card, the host) in fp64 against the card alone:
    the copies of the propagators to the host, the host's plain levels, and
    the backward through both copies."""
    import numpy as np

    from hyphy_tpu_torch.convert import params_from_numpy
    from hyphy_tpu_torch.data.filter import DataFilter
    from hyphy_tpu_torch.data.genetic_code import GeneticCode
    from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
    from hyphy_tpu_torch.models import frequencies as freq_mod
    from hyphy_tpu_torch.models.codon import MG94xREVPartitionedOmega
    from hyphy_tpu_torch.tree.topology import Tree

    gc = GeneticCode("Universal")
    filt = DataFilter.from_alignment(aln, "codon", genetic_code=gc)
    tree = Tree.from_newick(newick, leaf_order=filt.names)
    corners, codon_freqs = freq_mod.f3x4(filt, gc)
    nb = tree.n_branches
    model = MG94xREVPartitionedOmega(
        gc, corners, codon_freqs, nuc_lengths=np.linspace(0.05, 0.3, nb),
        branch_groups=np.zeros(nb, dtype=np.int32), n_groups=1, free_lengths=True,
        device=DEVICE)
    point = {f"theta_{p}": np.float64(v) for p, v in
             zip(("AC", "AT", "CG", "CT", "GT"), (0.4, 0.3, 0.6, 1.4, 0.5))}
    point.update(alpha=np.linspace(0.05, 0.3, nb), omega=np.array([0.3]))
    params = params_from_numpy(point, DEVICE)
    part = [Partition(filt, tree, model)]
    lf0 = LikelihoodFunction(part, dtype=torch.float64, device=DEVICE, mesh=None)
    lfm = LikelihoodFunction(part, dtype=torch.float64, device=DEVICE, mesh=(DEVICE, "cpu"))
    t0 = time.perf_counter()
    out = _mesh_compare(torch, _lf_value_grad(torch, lf0, params),
                        _lf_value_grad(torch, lfm, params), "mixed (cuda:0, cpu)", "float64",
                        grad_keys=["alpha"])
    out["seconds"] = time.perf_counter() - t0
    out["patterns"] = filt.n_patterns
    return out


def _mesh_fel(torch, fasta: str, newick: str, mesh, label: str, atol: float,
              precision=None, timed: bool = False) -> dict:
    """(c): FEL capped over ``mesh`` (``settings.mesh``), against the
    unsharded per-site stage on the run's own global fit, every column
    within ``atol``; both with the fused Nelder-Mead probes (at 128 sites
    their time is host launch time, and the fused body gives the sequential
    probes' results bit for bit), in ``precision``
    (``HYPHY_TPU_PRECISION``) when given; ``timed``: the per-site stage
    again over the mesh, timed, and once each way under the profiler (the
    per-card kernel windows of :func:`_mesh_overlap`)."""
    import numpy as np

    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.methods import fel
    from hyphy_tpu_torch.ops.level_products import level_products

    res = {"mesh": [str(d) for d in mesh]}
    saved = settings.warmup, settings.mesh
    env = {"HYPHY_TPU_NM_FUSED": "1", "HYPHY_TPU_PRECISION": precision}
    saved_env = {k: os.environ.get(k) for k in env}
    settings.warmup, settings.mesh = True, mesh
    for k, v in env.items():
        if v is not None:
            os.environ[k] = v
    try:
        level_products.launches = 0
        t0 = time.perf_counter()
        run = fel.run(fasta, tree=newick, device=DEVICE)
        torch.cuda.synchronize()
        res["sharded_run_s"] = time.perf_counter() - t0
        res["sharded_k1_launches"] = level_products.launches
        settings.mesh = (DEVICE,)                 # a mesh of one device is no mesh
        t0 = time.perf_counter()
        table, _ = fel.solve_partition(run.data, run.mg94)
        torch.cuda.synchronize()
        res["unsharded_site_stage_s"] = time.perf_counter() - t0
        if timed:
            settings.mesh = mesh
            t0 = time.perf_counter()
            again, _ = fel.solve_partition(run.data, run.mg94)
            torch.cuda.synchronize()
            res["sharded_site_stage_s"] = time.perf_counter() - t0
            check(np.array_equal(again, run.site_table, equal_nan=True),
                  "FEL's sharded per-site stage changed between two runs")
            for tag, m in (("unsharded", (DEVICE,)), ("sharded", mesh)):
                settings.mesh = m
                res[f"overlap_{tag}"] = _mesh_overlap(
                    torch, lambda: fel.solve_partition(run.data, run.mg94),
                    os.path.join("chiprun_out", f"profile_mesh_fel_{tag}.txt"), warm=False)
    finally:
        settings.warmup, settings.mesh = saved
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    diff = np.abs(run.site_table - table).max(axis=0)
    res["max_abs_diff_by_column"] = [float(x) for x in diff]
    res["sites"] = int(table.shape[0])
    log(f"[mesh] fel capped on {label} over {res['mesh']}: {res['sharded_run_s']:.2f} s, "
        f"K1 {res['sharded_k1_launches']}; the unsharded per-site stage on its fit "
        f"{res['unsharded_site_stage_s']:.2f} s; site table max |d| per column "
        f"{res['max_abs_diff_by_column']} (bound {atol:.0e})")
    if timed:
        log(f"[mesh] fel per-site stage on {label}: sharded {res['sharded_site_stage_s']:.3f} s, "
            f"unsharded {res['unsharded_site_stage_s']:.3f} s; profiled: unsharded "
            f"{res['overlap_unsharded']}, sharded {res['overlap_sharded']}")
    check(run.site_table.shape == table.shape, "sharded FEL table of another shape")
    check(bool(np.isfinite(run.site_table).all()), "non-finite sharded FEL table")
    check(float(diff.max()) <= atol, "sharded FEL site table off the unsharded")
    check(res["sharded_k1_launches"] > 0, "the sharded FEL run launched no K1")
    return res


def _mesh_busted(torch, sim_aln, sim_newick: str, mesh) -> dict:
    """(d): the BUSTED mixture at MESH_BUSTED_CODONS planted codons (3 omega
    classes x 3 synonymous-rate classes), sharded against unsharded."""
    import numpy as np

    from hyphy_tpu_torch.data.alignment import Alignment
    from hyphy_tpu_torch.data.filter import DataFilter
    from hyphy_tpu_torch.data.genetic_code import GeneticCode
    from hyphy_tpu_torch.models import frequencies as freq_mod
    from hyphy_tpu_torch.models.bsrel import BSRELEngine
    from hyphy_tpu_torch.models.codon import MG94Base
    from hyphy_tpu_torch.ops import pruning
    from hyphy_tpu_torch.tree.topology import Tree

    gc = GeneticCode("Universal")
    cut = Alignment(names=list(sim_aln.names),
                    sequences=[sq[: 3 * MESH_BUSTED_CODONS] for sq in sim_aln.sequences])
    filt = DataFilter.from_alignment(cut, "codon", genetic_code=gc)
    tree = Tree.from_newick(sim_newick, leaf_order=filt.names)
    corners, codon_freqs = freq_mod.f3x4(filt, gc)
    mg94 = MG94Base(gc, corners, codon_freqs, device=DEVICE)
    pdata = pruning.build_pruning_data(tree, DEVICE)
    group = np.zeros(tree.n_branches, dtype=np.int64)
    f64 = dict(dtype=torch.float64, device=DEVICE)
    thetas = {f"theta_{p}": torch.tensor(v, **f64) for p, v in
              zip(("AC", "AT", "CG", "CT", "GT"), (0.4, 0.3, 0.6, 1.4, 0.5))}
    fixed = dict(omegas=torch.tensor([[0.1, 0.8, 4.0]], **f64),
                 weights=torch.tensor([[0.6, 0.3, 0.1]], **f64),
                 srv_rates=torch.tensor([0.4, 1.0, 2.0], **f64),
                 srv_weights=torch.tensor([0.3, 0.5, 0.2], **f64))
    t_b = torch.as_tensor(np.maximum(tree.input_lengths[:-1], 1e-3), **f64)
    res = {"patterns": filt.n_patterns}
    saved = os.environ.get("HYPHY_TPU_PRECISION")
    try:
        for name in ("float32", "float64"):
            os.environ["HYPHY_TPU_PRECISION"] = name
            args = (mg94, pdata, filt.leaf_partials(), filt.pattern_weights, group, 3)
            e0 = BSRELEngine(*args, mesh=None)
            em = BSRELEngine(*args, mesh=mesh)

            def value_grad(engine):
                def run():
                    p = {k: v.detach().requires_grad_() for k, v in thetas.items()}
                    t = t_b.detach().requires_grad_()
                    value = engine.loglik(p, fixed["omegas"], fixed["weights"], t,
                                          fixed["srv_rates"], fixed["srv_weights"])
                    value.backward()
                    with torch.no_grad():
                        site = engine.site_log_likelihoods(
                            thetas, fixed["omegas"], fixed["weights"], t_b,
                            fixed["srv_rates"], fixed["srv_weights"])
                    return value.detach(), site, dict({k: p[k].grad for k in p}, t_b=t.grad)
                return run

            # fp64: the spectral route's eigh backward sits on the thetas'
            # path, as in (a)
            row = _mesh_compare(torch, value_grad(e0), value_grad(em), "BUSTED mixture", name,
                                grad_keys=["t_b"] if name == "float64" else None)
            row["unsharded_value_grad_ms"] = _eval_stats(wall_ms(torch, value_grad(e0),
                                                                 MESH_REPS))
            row["sharded_value_grad_ms"] = _eval_stats(wall_ms(torch, value_grad(em), MESH_REPS))
            log(f"[mesh] BUSTED {name}: ms per value+gradient (and site vector) unsharded "
                f"{row['unsharded_value_grad_ms']}, sharded {row['sharded_value_grad_ms']}")
            res[name] = row
    finally:
        if saved is None:
            os.environ.pop("HYPHY_TPU_PRECISION", None)
        else:
            os.environ["HYPHY_TPU_PRECISION"] = saved
    return res


def _mesh_site_hold(torch, name: str, run, mesh, rel_bound: float, grid: bool) -> dict:
    """``run()`` -> {key: tensor} unsharded, then over ``mesh`` with every
    block's device and K1's launches per device recorded: every output of
    the same shape with its infinities in place, and equal bit for bit
    (``rel_bound`` 0) or within ``rel_bound`` (relative above 1, absolute
    below); a block on every
    device of the mesh, and for a grid pass (``grid``) K1 launched on
    every card of it.  Returns the row and both outputs."""
    import numpy as np

    from hyphy_tpu_torch.config import settings

    settings.mesh = (DEVICE,)
    t0 = time.perf_counter()
    one = run()
    torch.cuda.synchronize()
    row = {"unsharded_s": time.perf_counter() - t0}
    settings.mesh = mesh
    seen = _mesh_launch_devices(torch)
    try:
        with _recorded_solves([]) as blocks:
            t0 = time.perf_counter()
            sharded = run()
            torch.cuda.synchronize()
            row["sharded_s"] = time.perf_counter() - t0
    finally:
        seen.pop("restore")()
        settings.mesh = (DEVICE,)
    row["blocks"] = [(b["device"], b["items"], b["chunk"]) for b in blocks]
    row["k1_by_device"] = dict(seen)
    row["outputs"], worst, equal = {}, 0.0, True
    for key in one:
        a, b = sharded[key].double().cpu().numpy(), one[key].double().cpu().numpy()
        check(a.shape == b.shape, f"{name} {key}: sharded shape {a.shape}, not {b.shape}")
        check(np.array_equal(np.isinf(a), np.isinf(b)) and np.array_equal(np.isnan(a),
                                                                         np.isnan(b)),
              f"{name} {key}: sharded non-finite entries elsewhere")
        fin = np.isfinite(b)
        # relative above 1, absolute below: EBFs and posteriors near 0 come
        # out of cancellations
        rel = np.abs(a[fin] - b[fin]) / np.maximum(np.abs(b[fin]), 1.0)
        row["outputs"][key] = float(rel.max()) if rel.size else 0.0
        worst = max(worst, row["outputs"][key])
        equal = equal and bool(np.array_equal(a, b, equal_nan=True))
    row["max_rel"], row["equal"] = worst, equal
    devices = sorted({str(d) for d in mesh})
    log(f"[mesh] (e) {name} over {[str(d) for d in mesh]}: unsharded {row['unsharded_s']:.3f} s, "
        f"sharded {row['sharded_s']:.3f} s; blocks (device, items, chunk) {row['blocks']}; K1 "
        f"per device {row['k1_by_device']}; equal {equal}, max rel {worst:.3e} (bound "
        f"{rel_bound:.0e}) {row['outputs']}")
    check(equal if rel_bound == 0 else worst <= rel_bound,
          f"{name}: the sharded solve is off the unsharded one")
    check(sorted({b["device"] for b in blocks}) == devices,
          f"{name}: blocks on {sorted({b['device'] for b in blocks})}, the mesh holds {devices}")
    if grid:
        cards = [d for d in devices if d.startswith("cuda")]
        check(all(row["k1_by_device"].get(d, 0) > 0 for d in cards),
              f"{name}: K1 launched on {row['k1_by_device']}, the mesh's cards are {cards}")
    return row, one, sharded


def _mesh_sites(torch, aln, newick: str, tmp: str, mesh, distinct: bool) -> dict:
    """(e): every per-site solve that the JAX package shards, but FEL's,
    sharded against unsharded on one capped global fit; MEME's stages also
    profiled both ways; then the grid pass and the EBFs over (card, host)."""
    import numpy as np

    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.data.alignment import Alignment, read_alignment
    from hyphy_tpu_torch.data.filter import DataFilter
    from hyphy_tpu_torch.data.genetic_code import AMINO_ACIDS
    from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
    from hyphy_tpu_torch.methods import (common, contrast_fel, contrast_meme, fade, fubar,
                                         leisr, meme, prime)
    from hyphy_tpu_torch.methods.grid_bayes import posterior_over_grid
    from hyphy_tpu_torch.models import frequencies as freq_mod
    from hyphy_tpu_torch.models.codon import MG94Base
    from hyphy_tpu_torch.models.protein import EmpiricalProtein
    from hyphy_tpu_torch.optimize import nelder_mead
    from hyphy_tpu_torch.parallel.mesh import data_mesh
    from hyphy_tpu_torch.tree.topology import Tree

    t_setup = time.perf_counter()
    fasta = _cut_fasta(aln, os.path.join(tmp, "mesh_sites.fasta"), MESH_SITE_CODONS)
    tree = Tree.from_newick(newick)
    clades = _contrast_clades(tree, MESH_SITE_CLADES)
    labelled = _labelled_newick(
        tree, np.maximum(np.asarray(tree.input_lengths[:-1]), 1e-6),
        {nd: lbl for lbl, clade in zip(CONTRAST_LABELS, clades) for nd in clade})
    rng = np.random.default_rng(SEED)
    prot = Alignment(list(aln.names), ["".join(rng.choice(list(AMINO_ACIDS), MESH_SITE_CODONS))
                                       for _ in aln.names])
    pfilt = DataFilter.from_alignment(prot, "protein")
    ptree = Tree.from_newick(newick, leaf_order=pfilt.names)
    nfilt = DataFilter.from_alignment(read_alignment(fasta), "nucleotide")
    ntree = Tree.from_newick(newick, leaf_order=nfilt.names)
    saved = (settings.warmup, settings.mesh, nelder_mead._WARMUP_ITERATIONS,
             os.environ.get("HYPHY_TPU_NM_FUSED"))
    settings.warmup, settings.mesh = True, (DEVICE,)
    nelder_mead._WARMUP_ITERATIONS = MESH_SITE_NM
    os.environ["HYPHY_TPU_NM_FUSED"] = "1"
    res = {"codons": MESH_SITE_CODONS, "nelder_mead_cap": MESH_SITE_NM}
    try:
        data = common.load_codon_data(fasta, tree_newick=newick, device=DEVICE)
        gtr = common.fit_gtr(data)
        mg = common.fit_partitioned_mg94(data, gtr)
        cdata = contrast_fel.load_multigroup(fasta, "Universal", labelled, list(CONTRAST_LABELS),
                                             device=DEVICE)
        _, cmg = contrast_fel.global_fits(cdata, 1e-3)
        dtype = settings.likelihood_dtype(DEVICE)
        nmodel = leisr._nucleotide_model("GTR", nfilt, DEVICE)
        nfit = leisr.fit_baseline(LikelihoodFunction([Partition(nfilt, ntree, nmodel)],
                                                     device=DEVICE), ntree, 1e-3)
        nloglik_on = leisr.site_log_likelihood_on(nmodel, nfit.params, nfilt, ntree, dtype,
                                                  spectral=dtype == torch.float64)
        torch.cuda.synchronize()
        res["setup_s"] = time.perf_counter() - t_setup
        res["patterns"] = data.codon_filter.n_patterns

        corners, codon_freqs = freq_mod.cf3x4(data.codon_filter, data.genetic_code,
                                              device=DEVICE)
        grid_model = MG94Base(data.genetic_code, corners, codon_freqs, device=DEVICE)
        theta = {k: v.to(DEVICE) for k, v in gtr.params.items() if k.startswith("theta")}
        grid_t = torch.as_tensor(fubar.alpha_beta_grid(MESH_SITE_GRID), device=DEVICE)
        times = torch.as_tensor(3.0 * gtr.branch_lengths, device=DEVICE)

        def fubar_pass(gp):
            def run():
                sll = fubar.grid_pass(gp, grid_t, times)
                cond = fubar.conditionals(sll.double().cpu().numpy(), data.codon_filter)
                return {"sll": sll, "posterior": torch.as_tensor(
                    posterior_over_grid("Variational-Bayes", cond)[0])}
            return run

        fade_gp = fade.grid_pruning(
            EmpiricalProtein("WAG", frequencies=freq_mod.empirical_character(pfilt),
                             device=DEVICE), pfilt, ptree,
            torch.as_tensor(np.maximum(ptree.input_lengths[:-1], 1e-3), device=DEVICE),
            ptree.select_branches("All"))
        fade_grid = torch.as_tensor(fade.define_grid(MESH_SITE_GRID), device=DEVICE)
        sites = meme.mixture_sites(data, mg, dtype, spectral=dtype == torch.float64,
                                   rate_classes=2)
        specs = meme._specs(2, False, {})
        n = data.codon_filter.n_patterns
        tested_idx = np.nonzero(data.tested_branches)[0]
        held = {}

        def meme_stages_of(stage_sites, n_items):
            def run():
                out = meme.site_pipeline(stage_sites, specs, {}, False, n_items, DEVICE)
                return {f"{stage}_{k}": v for stage, fitted in zip(("fel", "alt", "null"), out)
                        for k, v in fitted.items()}
            return run

        meme_stages = meme_stages_of(sites, n)

        def meme_ebf():
            alt = {k[4:]: v for k, v in held["meme_stages"].items() if k.startswith("alt_")}
            return {"ebf": torch.as_tensor(meme.branch_ebfs(sites, alt, tested_idx))}

        groups = np.asarray(cdata.branch_groups)
        job_sites = np.arange(min(len(mesh), cdata.codon_filter.n_patterns))
        job_groups = np.stack([rng.permutation(groups) for _ in job_sites])
        dists = torch.as_tensor(np.stack(prime.property_distance_tensors(data.genetic_code)),
                                dtype=torch.float64, device=DEVICE)

        def leisr_sites():
            def run():
                out = leisr.fit_sites(nloglik_on, nfilt.n_patterns,
                                      leisr._site_bytes(ntree, dtype, nmodel.n_states), DEVICE)
                return dict(zip(("r", "lo", "hi", "global", "local"),
                                (torch.as_tensor(v) for v in out)))
            return run

        def tensors(out):
            return {k: torch.as_tensor(v) for k, v in out.items()}

        calls = [
            ("fubar_grid", fubar_pass(fubar.grid_pruning(data, grid_model, theta)), True),
            ("fade_target", lambda: {"sll": fade.grid_pass(fade_gp, fade_grid,
                                                           AMINO_ACIDS.index(FADE_TARGET))},
             True),
            ("meme_stages", meme_stages, False),
            ("meme_ebf", meme_ebf, False),
            ("contrast_fel", lambda: dict(zip(
                ("alpha", "betas", "alt_lnl", "null_lnl", "pair_lnl"),
                (torch.as_tensor(v) for v in contrast_fel.fit_sites(cdata, cmg, True)))), False),
            ("contrast_meme_fits", lambda: tensors(contrast_meme.fit_sites(cdata, cmg, True)),
             False),
            ("contrast_meme_permutation", lambda: {"lrt": torch.as_tensor(
                contrast_meme.permutation_lrts(cdata, cmg, True, job_sites, job_groups))}, False),
            ("prime", lambda: tensors(prime.fit_sites(data, mg, dists)), False),
            ("leisr", leisr_sites(), False),
        ]
        # bit for bit on cards; a (card, host) mesh is (b)-(c)'s and below
        bound = 0.0 if all(d.type == "cuda" for d in data_mesh(mesh)) else MESH_MIXED_SITE_REL
        res["calls"] = {}
        for name, run, grid in calls:
            res["calls"][name], held[name], _ = _mesh_site_hold(torch, name, run, mesh, bound,
                                                                grid)
        # on distinct cards, MEME's stages profiled both ways (warm: they ran
        # twice above)
        for tag, m in (("unsharded", (DEVICE,)), ("sharded", mesh)) if distinct else ():
            settings.mesh = m
            res["calls"]["meme_stages"][f"overlap_{tag}"] = _mesh_overlap(
                torch, meme_stages, os.path.join("chiprun_out", f"profile_mesh_meme_{tag}.txt"),
                warm=False)
            log(f"[mesh] (e) MEME stages {tag}, profiled: "
                f"{res['calls']['meme_stages'][f'overlap_{tag}']}")
        settings.mesh = (DEVICE,)

        # over (card, host) in fp64: the grid pass and MEME's stages on a few
        # sites
        mixed = data_mesh((DEVICE, "cpu"))
        os.environ["HYPHY_TPU_PRECISION"] = "float64"
        res["mixed"] = {}
        for name, run, grid in (
                ("fubar_grid", fubar_pass(fubar.grid_pruning(data, grid_model, theta)), True),
                ("meme_stages", meme_stages_of(meme.mixture_sites(
                    data, mg, torch.float64, True, 2), MESH_MIXED_SITES), False)):
            res["mixed"][name], _, _ = _mesh_site_hold(torch, f"{name} (card, host) fp64", run,
                                                       mixed, MESH_MIXED_SITE_REL, grid)
    finally:
        settings.warmup, settings.mesh, nelder_mead._WARMUP_ITERATIONS, fused = saved
        os.environ.pop("HYPHY_TPU_PRECISION", None)
        if fused is None:
            os.environ.pop("HYPHY_TPU_NM_FUSED", None)
        else:
            os.environ["HYPHY_TPU_NM_FUSED"] = fused
    return res


def _mesh_width(torch, aln, newick: str, sim_aln, sim_newick: str, tmp: str, mesh) -> dict:
    """(f), ``--mesh-width``: the per-site stages at the widths of the
    default phases, on one card and over ``mesh`` (every card of the host):
    FEL's per-site stage on phase 4's input (N_TAXA x N_CODONS, the global
    fit capped as phase 4 runs it) and MEME's three stages on phase 11's
    (the planted alignment's first MEME_CODONS codons, its fits capped), as
    a user runs them (the sequential Nelder-Mead probes).  Over the mesh
    once under the profiler (which warms every card: per-card kernel
    windows and their overlap), then timed; then on one card, timed; the
    outputs equal bit for bit.  What decides whether the automatic mesh
    splits a per-site solve."""
    import numpy as np

    from hyphy_tpu_torch.config import settings
    from hyphy_tpu_torch.methods import common, fel, meme

    res = {"mesh": [str(d) for d in mesh]}
    saved = settings.warmup, settings.mesh
    settings.warmup, settings.mesh = True, (DEVICE,)
    try:
        fasta = os.path.join(tmp, "mesh_width.fasta")
        _write_fasta(fasta, aln.names, aln.sequences)
        t0 = time.perf_counter()
        run = fel.run(fasta, tree=newick, device=DEVICE)      # on one card
        torch.cuda.synchronize()
        res["fel_run_s"] = time.perf_counter() - t0
        res["fel_sites"] = int(run.site_table.shape[0])

        t0 = time.perf_counter()
        data = common.load_codon_data(_cut_fasta(sim_aln, os.path.join(
            tmp, "mesh_width_meme.fasta"), MEME_CODONS), tree_newick=sim_newick, device=DEVICE)
        mg = common.fit_partitioned_mg94(data, common.fit_gtr(data))
        dtype = settings.likelihood_dtype(DEVICE)
        sites = meme.mixture_sites(data, mg, dtype, spectral=dtype == torch.float64,
                                   rate_classes=2)
        specs = meme._specs(2, False, {})
        n = data.codon_filter.n_patterns
        torch.cuda.synchronize()
        res["meme_fits_s"] = time.perf_counter() - t0
        res["meme_sites"] = n

        def fel_stage():
            return [fel.solve_partition(run.data, run.mg94)[0]]

        def meme_stages():
            out = meme.site_pipeline(sites, specs, {}, False, n, DEVICE)
            return [v.double().cpu().numpy() for fitted in out
                    for _, v in sorted(fitted.items())]

        for name, stage in (("fel", fel_stage), ("meme", meme_stages)):
            row = res[name] = {}
            settings.mesh = mesh
            row["overlap_sharded"] = _mesh_overlap(
                torch, stage, os.path.join("chiprun_out", f"profile_width_{name}_sharded.txt"),
                warm=False)
            t0 = time.perf_counter()
            sharded = stage()
            torch.cuda.synchronize()
            row["sharded_s"] = time.perf_counter() - t0
            settings.mesh = (DEVICE,)
            t0 = time.perf_counter()
            one = stage()
            torch.cuda.synchronize()
            row["unsharded_s"] = time.perf_counter() - t0
            row["sharded_over_unsharded"] = row["sharded_s"] / row["unsharded_s"]
            row["equal"] = all(np.array_equal(a, b, equal_nan=True) for a, b in zip(sharded, one))
            log(f"[mesh] (f) {name} per-site stage(s) at full width over {res['mesh']}: "
                f"sharded {row['sharded_s']:.3f} s, one card {row['unsharded_s']:.3f} s "
                f"({row['sharded_over_unsharded']:.3f}x); equal {row['equal']}; profiled "
                f"sharded {row['overlap_sharded']}")
            check(row["equal"] and len(sharded) == len(one),
                  f"(f) {name}: the sharded stage is off the one-card stage")
    finally:
        settings.warmup, settings.mesh = saved
    log(f"[mesh] (f) fel.run on {N_TAXA} x {N_CODONS} (one card, capped) {res['fel_run_s']:.2f} "
        f"s; MEME's fits on {MEME_CODONS} codons {res['meme_fits_s']:.2f} s")
    return res


def phase_mesh_width(torch, aln, newick: str, sim_aln, sim_tree: str, tmp: str) -> dict:
    """``--mesh-width``: (f) over every card of the host (four shards of the
    one card on a host with one); K1 launches counted from 0 around it (the
    global fits launch them; the per-site routes launch none)."""
    from hyphy_tpu_torch.ops.level_products import level_products
    from hyphy_tpu_torch.parallel.mesh import data_mesh

    mesh = data_mesh(None if torch.cuda.device_count() >= 2 else (DEVICE,) * MESH_SHARDS)
    with open(sim_tree) as fh:
        sim_newick = fh.read()
    level_products.launches = 0
    res = _mesh_width(torch, aln, newick, sim_aln, sim_newick, tmp, mesh)
    res["level_products_launches"] = level_products.launches
    check(res["level_products_launches"] > 0, "(f) launched no K1")
    return res


def phase_mesh(torch, aln, newick: str, sim_aln, sim_tree: str, tmp: str) -> dict:
    """Phase 30, the device mesh (``parallel/mesh.py``): (a)-(e) above; K1
    launches counted from 0 around them."""
    from hyphy_tpu_torch.ops.level_products import level_products

    from hyphy_tpu_torch.parallel.mesh import data_mesh

    n_cards = torch.cuda.device_count()
    distinct = n_cards >= 2
    mesh = data_mesh(None if distinct else (DEVICE,) * MESH_SHARDS)
    devices = [str(d) for d in mesh]
    log(f"[mesh] devices {devices}, distinct_cards {distinct}")
    res, stages = {"devices": devices, "distinct_cards": distinct}, {}

    def stage(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    level_products.launches = 0
    res["gene"] = stage("gene", _mesh_gene, torch, aln, newick, mesh, distinct)
    small_aln, small_newick, small_fasta = _mesh_small_input(tmp)
    res["mixed"] = stage("mixed", _mesh_mixed, torch, small_aln, small_newick)
    # the per-site solves on one card over MESH_SITE_SHARDS shards of it
    site_mesh = mesh if distinct else data_mesh((DEVICE,) * MESH_SITE_SHARDS)
    res["fel"] = stage("fel", _mesh_fel, torch, small_fasta, small_newick, site_mesh,
                       f"{MESH_SMALL_TAXA} x {MESH_SMALL_CODONS}", MESH_TABLE_ATOL, None,
                       distinct)
    # the per-site solves on distinct devices whatever the host's count: a
    # tensor left on the first device fails there
    mixed_fasta = _cut_fasta(small_aln, os.path.join(tmp, "mesh_mixed.fasta"),
                             MESH_MIXED_CODONS)
    res["fel_mixed"] = stage("fel_mixed", _mesh_fel, torch, mixed_fasta, small_newick,
                             data_mesh((DEVICE, "cpu")),
                             f"{MESH_SMALL_TAXA} x {MESH_MIXED_CODONS}, fp64",
                             MESH_MIXED_TABLE_ATOL, "float64")
    with open(sim_tree) as fh:
        sim_newick = fh.read()
    res["busted"] = stage("busted", _mesh_busted, torch, sim_aln, sim_newick, mesh)
    res["sites"] = stage("sites", _mesh_sites, torch, small_aln, small_newick, tmp, site_mesh,
                         distinct)
    res["level_products_launches"] = level_products.launches
    res["stages_s"] = stages
    log(f"[mesh] stages, s: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f"; K1 launches {res['level_products_launches']}")
    check(res["level_products_launches"] > 0, "the mesh phase launched no K1")
    return res


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hyphy_tpu_torch.config import resolve_device
    from hyphy_tpu_torch.ops.cuda_build import SOURCES

    resolve_device(DEVICE)        # also turns TF32 off for fp32 matmuls
    os.makedirs("chiprun_out", exist_ok=True)   # profiles and the record
    record = {"card": phase_card(torch), "build": phase_build()}
    record["kernels"] = phase_kernels(torch)
    full_fit = "--full-fit" in argv
    precision_check = "--precision-check" in argv
    busted_check = "--busted-check" in argv
    relax_check = "--relax-check" in argv
    mesh_only = "--mesh" in argv
    mesh_width = "--mesh-width" in argv
    with tempfile.TemporaryDirectory() as tmp:
        if precision_check:
            record["precision"] = phase_precision(torch, tmp)
            main_phases = ("precision",)
        elif busted_check:
            record["busted_check"] = phase_busted_check(torch, tmp)
            main_phases = ("busted_check",)
        elif relax_check:
            record["relax_check"] = phase_relax_check(torch, tmp)
            main_phases = ("relax_check",)
        elif mesh_only or mesh_width:
            aln, newick, _, _ = _write_inputs(tmp)
            sim_aln, _, sim_tree = _planted_alignment(tmp)
            name, phase = (("mesh", phase_mesh) if mesh_only
                           else ("mesh_width", phase_mesh_width))
            record[name] = phase(torch, aln, newick, sim_aln, sim_tree, tmp)
            main_phases = (name,)
        else:
            main_phases = _default_phases(torch, record, tmp, full_fit)
    checks = precision_check or busted_check or relax_check or mesh_only or mesh_width

    wide = next(r for r in record["kernels"]["shapes"]
                if r["shape"] == list(KERNEL_SHAPES[1]) and r["dtype"] == "float32")
    per_eval = next(r for r in record["kernels"]["evaluation"]
                    if r["states"] == 61 and r["dtype"] == "float32")
    protein = next(r for r in record["kernels"]["shapes"]
                   if r["shape"] == list(KERNEL_SHAPES[4]) and r["dtype"] == "float32")
    nucleotide = next(r for r in record["kernels"]["shapes"]
                      if r["shape"] == list(KERNEL_SHAPES[3]) and r["dtype"] == "float32")
    protein_eval = next(r for r in record["kernels"]["evaluation"]
                        if r["states"] == 20 and r["dtype"] == "float32")
    binary = next(r for r in record["kernels"]["shapes"]
                  if r["shape"] == list(KERNEL_SHAPES[5]) and r["dtype"] == "float32")
    binary_eval = next(r for r in record["kernels"]["evaluation"]
                       if r["states"] == 2 and r["dtype"] == "float32")
    if not checks:
        # K1 inside a real fp32 evaluation (phase 5's profile) against phase
        # 3's per-level times on fresh random inputs, level by level
        in_eval = record["parity"]["float32"]["profile_value"]["k1_launch_ms"]
        check(len(in_eval) == len(LEVEL_WIDTHS), "the fp32 profile lost K1 launches")
        log(f"[kernel] level_products fp32 per evaluation: phase 3 {per_eval['ms']:.4f} ms, "
            f"inside the profiled evaluation {sum(in_eval):.4f} ms; per level, phase 3 / "
            f"evaluation: {[round(a / b, 3) for a, b in zip(per_eval['per_level_ms'], in_eval)]}")
    by_phase = {phase: record[phase]["level_products_launches"] for phase in main_phases}
    log(f"[kernel] level_products launches per phase: {by_phase}")
    launches = {"level_products": sum(by_phase.values())}
    kernels = [{
        "name": name, "route": "cuda", "status": "ok",
        "source": f"hyphy_tpu_torch/csrc/{name}.cu",
        "replaces": "hyphy_tpu/ops/pallas_pruning.py:38",
        "launches": launches[name], "max_abs_err": wide["max_abs_err"],
        "ms": wide["ms"], "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"],
        "bound_by": wide["bound_by"], "library_ms": wide["library_ms"],
        "eval_ms": per_eval["ms"], "eval_library_ms": per_eval["library_ms"],
        "eval_bound_ms": per_eval["bound_ms"],
        "protein_ms": protein["ms"], "protein_plain_ms": protein["plain_ms"],
        "protein_bound_ms": protein["bound_ms"], "protein_library_ms": protein["library_ms"],
        "protein_eval_ms": protein_eval["ms"], "protein_eval_bound_ms": protein_eval["bound_ms"],
        "nucleotide_ms": nucleotide["ms"], "nucleotide_plain_ms": nucleotide["plain_ms"],
        "nucleotide_bound_ms": nucleotide["bound_ms"],
        "nucleotide_library_ms": nucleotide["library_ms"],
        "binary_ms": binary["ms"], "binary_plain_ms": binary["plain_ms"],
        "binary_bound_ms": binary["bound_ms"], "binary_library_ms": binary["library_ms"],
        "binary_max_abs_err": binary["max_abs_err"], "binary_eval_ms": binary_eval["ms"],
        "binary_eval_bound_ms": binary_eval["bound_ms"],
        "launches_by_phase": by_phase,
    } for name in SOURCES]
    if not checks:
        kernels[0]["eval_profiled_ms"] = sum(in_eval)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(record, fh, indent=1)
    log(f"{record['card']['nvidia_smi']}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": record["card"]["name"],
        "count": record["card"]["count"]}}))
    return 0


def _default_phases(torch, record: dict, tmp: str, full_fit: bool):
    """Phases 4-30 into ``record``; returns the names of those that drive a
    method through its entry point (each reads K1's launch count around
    its run)."""
    def timed(name, fn, *args):
        t0 = time.perf_counter()
        record[name] = fn(*args)
        record.setdefault("phase_s", {})[name] = time.perf_counter() - t0
        log(f"[time] {name}: {record['phase_s'][name]:.2f} s")
        torch.cuda.empty_cache()

    def fused(name, fn, *args):
        # with the fused Nelder-Mead probes (HYPHY_TPU_NM_FUSED=1): phases
        # whose per-site fits hold at most ~512 items, where an evaluation is
        # host launch time and the fused body takes 0.30x the sequential
        # probes' time at 128 sites (PERF.md); the results are the same bit
        # for bit (the fused-probe phase's check)
        os.environ["HYPHY_TPU_NM_FUSED"] = "1"
        log(f"[{name}] fused Nelder-Mead probes (HYPHY_TPU_NM_FUSED=1)")
        try:
            timed(name, fn, *args)
        finally:
            del os.environ["HYPHY_TPU_NM_FUSED"]
        record[name]["fused_probes"] = True

    from hyphy_tpu_torch.config import settings

    # phases 4-29 on one card whatever the host's count (a mesh of one
    # device is no mesh); phase 30 names its meshes itself
    settings.mesh = (DEVICE,)
    aln, newick, fasta, tree_path = _write_inputs(tmp)
    timed("main_path", phase_main_path, torch, fasta, tree_path, tmp, full_fit)
    data, mgp = record["main_path"].pop("data"), record["main_path"].pop("mg94_fit")
    timed("parity", phase_parity, torch, aln, newick)
    timed("sites", phase_sites, torch, data, mgp)
    timed("fused_probes", phase_fused_probes, torch, data, mgp)
    del data, mgp
    timed("partitions", phase_partitions, torch, aln, newick, tmp, full_fit)
    # phase 8's CI is ~60 batched fits of 128 sites
    fused("options", phase_options, torch, tmp)
    sim_aln, sim_fasta, sim_tree = _planted_alignment(tmp)
    timed("slac", phase_slac, torch, sim_fasta, sim_tree, tmp)
    timed("simulate", phase_simulate, torch, sim_aln, sim_fasta, sim_tree, tmp)
    fused("meme", phase_meme, torch, sim_aln, sim_tree, tmp)
    timed("fubar", phase_fubar, torch, sim_fasta, sim_tree, tmp)
    timed("bstill", phase_bstill, torch, sim_aln, sim_tree, tmp)
    con_aln, con_fasta, con_tree = _contrast_alignment(tmp)
    fused("contrast_fel", phase_contrast_fel, torch, con_aln, con_tree, tmp)
    fused("contrast_meme", phase_contrast_meme, torch, con_aln, con_tree, tmp)
    timed("meme_resample", phase_meme_resample, torch, sim_aln, sim_tree, tmp)
    fused("prime", phase_prime, torch, sim_aln, sim_tree, tmp)
    timed("busted", phase_busted, torch, sim_fasta, sim_tree, tmp)
    timed("busted_e", phase_busted_e, torch, sim_aln, sim_tree, tmp)
    timed("busted_ph", phase_busted_ph, torch, con_aln, con_tree, tmp)
    timed("relax", phase_relax, torch, con_fasta, con_tree, tmp)
    timed("relax_groups", phase_relax_groups, torch, con_aln, con_tree, tmp)
    timed("absrel", phase_absrel, torch, tmp)
    prot_aln, prot_fasta, planted = _protein_alignment(tmp)
    timed("leisr", phase_leisr, torch, prot_fasta, fasta, tree_path, tmp)
    timed("fade", phase_fade, torch, prot_aln, planted, con_tree, tmp)
    timed("fmm", phase_fmm, torch, fasta, tree_path, tmp)
    timed("bgm", phase_bgm, torch, sim_aln, sim_tree, tmp)
    timed("gard", phase_gard, torch, tmp)
    timed("engine", phase_engine, torch, aln, fasta, newick, tmp)
    timed("mesh", phase_mesh, torch, aln, newick, sim_aln, sim_tree, tmp)
    return ("main_path", "partitions", "options", "slac", "simulate", "meme", "fubar",
            "bstill", "contrast_fel", "contrast_meme", "meme_resample", "prime", "busted",
            "busted_e", "busted_ph", "relax", "relax_groups", "absrel", "leisr", "fade", "fmm",
            "bgm", "gard", "engine", "mesh")

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
