"""Command-line interface: ``python -m hyphy_tpu_torch <method> --alignment ...``.

Counterpart of ``hyphy_tpu/cli.py`` for the ported methods (FEL, SLAC,
MEME, FUBAR, B-STILL, contrast-FEL, contrast-MEME, PRIME, BUSTED,
BUSTED-PH, RELAX, aBSREL, FitMultiModel, LEISR, FADE, BGM, GARD,
``simulate``, and the post-processors ``error-filter`` and
``clade-support``), with the JAX parser's flags; it
writes ``<alignment>.<METHOD>.json`` like the reference analyses do.  It
runs on ``settings.device`` — the card, raising without one; there is no
device flag, as the JAX CLI has none.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.io.json_out import write_json


def _bool(v: str) -> bool:
    return str(v).strip().lower() in ("yes", "true", "1", "on")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m hyphy_tpu_torch",
        description="Phylogenetic selection analyses on one CUDA card",
    )
    sub = parser.add_subparsers(dest="method", required=True)

    pw = sub.add_parser(
        "warmup",
        help="run a method's whole pipeline with every optimizer capped "
             "(L-BFGS at 3 iterations, Nelder-Mead at 32), so each code path "
             "runs once without paying for the fits.  Usage: warmup fel "
             "--alignment ...",
    )
    pw.add_argument("target", help="method to warm up (fel, slac, meme, fubar, b-still, "
                                   "contrast-fel, contrast-meme, simulate, prime, busted, "
                                   "busted-ph, relax, absrel, fmm, leisr, fade, bgm, "
                                   "gard)")
    pw.add_argument("rest", nargs=argparse.REMAINDER,
                    help="arguments passed through to the method")

    def common_args(p):
        p.add_argument("--alignment", required=True, help="in-frame codon alignment (FASTA/NEXUS/PHYLIP)")
        p.add_argument("--tree", default=None, help="newick tree (file or string; default: tree in the alignment file)")
        p.add_argument("--code", default="Universal", help="genetic code")
        p.add_argument("--output", default=None, help="output JSON path")

    def multihit_args(p):
        p.add_argument("--multiple-hits", dest="multiple_hits", default="None",
                       choices=["None", "Double", "Double+Triple"])
        p.add_argument("--site-multihit", dest="site_multihit", default="Estimate",
                       choices=["Estimate", "Global"])

    p = sub.add_parser("fel", help="Fixed Effects Likelihood site selection")
    common_args(p)
    p.add_argument("--branches", default="All")
    p.add_argument("--srv", default="Yes")
    p.add_argument("--pvalue", type=float, default=0.1)
    p.add_argument("--resample", type=int, default=0,
                   help="parametric-bootstrap replicates for per-site p-values")
    multihit_args(p)
    p.add_argument("--ci", default="No",
                   help="profile-likelihood confidence intervals on site dN/dS")

    p = sub.add_parser("slac", help="Single-Likelihood Ancestor Counting")
    common_args(p)
    p.add_argument("--branches", default="All")
    p.add_argument("--pvalue", type=float, default=0.1)
    p.add_argument("--samples", type=int, default=0,
                   help="ancestral-uncertainty resampling draws")

    p = sub.add_parser("meme", help="Mixed Effects Model of Evolution")
    common_args(p)
    p.add_argument("--branches", default="All")
    p.add_argument("--pvalue", type=float, default=0.1)
    p.add_argument("--rates", type=int, default=2,
                   help="number of omega rate classes [2-4]")
    p.add_argument("--resample", type=int, default=0,
                   help="parametric-bootstrap replicates for per-site p-values")
    multihit_args(p)

    def grid_args(p):
        p.add_argument("--branches", default="All")
        p.add_argument("--grid", type=int, default=20)
        p.add_argument("--method", dest="posterior_method", default="Variational-Bayes",
                       choices=["Variational-Bayes", "Collapsed-Gibbs"])
        p.add_argument("--concentration_parameter", type=float, default=0.5)

    p = sub.add_parser("fubar", help="Fast Unconstrained Bayesian AppRoximation")
    common_args(p)
    grid_args(p)

    p = sub.add_parser(
        "b-still",
        help="Bayesian Significance Test of Invariant Low Likelihoods",
    )
    common_args(p)
    grid_args(p)
    p.add_argument("--non-zero", dest="non_zero", default="No",
                   help="enforce non-zero synonymous rates on the grid")
    p.add_argument("--ebf", type=float, default=10.0,
                   help="EBF threshold for reporting proximal invariance")
    p.add_argument("--radius-threshold", dest="radius_threshold", type=float,
                   default=0.5,
                   help="substitution-scale radius defining 'proximal to 0'")

    def contrast_args(p):
        common_args(p)
        p.add_argument("--branch-set", dest="branch_sets", action="append",
                       default=None, help="tested branch label (repeatable)")
        p.add_argument("--srv", default="Yes")
        p.add_argument("--pvalue", type=float, default=0.05)
        p.add_argument("--qvalue", type=float, default=0.20)

    contrast_args(sub.add_parser(
        "contrast-fel", help="Tests for different selective pressures between branch sets"))
    p = sub.add_parser(
        "contrast-meme",
        help="Tests for different episodic selective pressures between branch sets")
    contrast_args(p)
    p.add_argument("--permutations", type=int, default=0,
                   help="permutation replicates for sites passing the LRT screen")

    p = sub.add_parser(
        "simulate",
        help="simulate codon alignments from the MG94xREV fit of the input "
             "(SimulateDataSet, likefunc.cpp:12584)",
    )
    common_args(p)
    p.add_argument("--branches", default="All")
    p.add_argument("--replicates", type=int, default=1)
    p.add_argument("--sites", type=int, default=None,
                   help="codons per replicate (default: input length)")
    p.add_argument("--sim-omega", dest="sim_omega", type=float, default=None,
                   help="override the fitted omega for the generating model")
    p.add_argument("--seed", type=int, default=0)

    def busted_args(p, branches):
        common_args(p)
        p.add_argument("--branches", default=branches)
        p.add_argument("--srv", default="Yes")
        p.add_argument("--rates", type=int, default=3)
        p.add_argument("--syn-rates", dest="syn_rates", type=int, default=3)
        p.add_argument("--starting-points", dest="starting_points", type=int, default=1)
        p.add_argument("--multiple-hits", dest="multiple_hits", default="None",
                       choices=["None", "Double", "Double+Triple"])

    p = sub.add_parser("busted", help="Branch-Site Unrestricted Statistical Test")
    busted_args(p, "All")
    p.add_argument("--srv-hmm", dest="srv_hmm", action="store_true",
                   help="synonymous rate classes follow an HMM across sites")
    p.add_argument("--save-fit", dest="save_fit", default=None,
                   help="cache the unconstrained-model fit at this path and reuse it on reruns")
    p.add_argument("--error-sink", dest="error_sink", action="store_true",
                   help="add the BUSTED-E misalignment-absorbing class")
    p.add_argument("--srv-branchsite", dest="srv_branchsite", action="store_true",
                   help="branch-site synonymous rate variation")

    p = sub.add_parser("busted-ph", help="BUSTED phenotype/trait association test")
    busted_args(p, "Foreground")
    p.add_argument("--error-sink", dest="error_sink", action="store_true")

    p = sub.add_parser("error-filter", help="mask alignment error flagged by a BUSTED-E run")
    p.add_argument("--json", required=True, help="BUSTED-E result JSON (busted --error-sink)")
    p.add_argument("--output", required=True, help="masked FASTA path")
    p.add_argument("--output-json", dest="output_json", default=None,
                   help="machine-readable filter report path")
    p.add_argument("--threshold", type=float, default=100.0,
                   help="EBF error threshold for masking sites")
    p.add_argument("--ratio", type=float, default=20.0, help="EBF for error vs selection")
    p.add_argument("--site-threshold", dest="site_threshold", type=float, default=0.4,
                   help="mask the entire site if more than this fraction of sequences is flagged")

    p = sub.add_parser("clade-support", help="Effective Clade Breadth from a BUSTED-PH result")
    p.add_argument("--json", required=True, help="BUSTED-PH result JSON")
    p.add_argument("--output", default=None, help="output JSON path")

    p = sub.add_parser("relax", help="Relaxation of selection test")
    common_args(p)
    p.add_argument("--test", default=None)
    p.add_argument("--reference", default=None)
    p.add_argument("--rates", type=int, default=3)
    p.add_argument("--models", default="All", choices=["All", "Minimal"])
    p.add_argument("--groups", default=None,
                   help="comma-separated branch-set labels: group mode "
                        "(>= 3 sets, per-group K); --reference names the "
                        "reference set")

    p = sub.add_parser("absrel", help="adaptive Branch-Site REL")
    common_args(p)
    p.add_argument("--branches", default="All")
    p.add_argument("--pvalue", type=float, default=0.05)
    p.add_argument("--multiple-hits", dest="multiple_hits", default="None",
                   choices=["None", "Double", "Double+Triple"])
    p.add_argument("--srv", default="No",
                   help="include synonymous rate variation (shared GDD)")
    p.add_argument("--syn-rates", dest="syn_rates", type=int, default=3)

    p = sub.add_parser("prime",
                       help="PRoperty Informed Model of Evolution (per-site property LRTs)")
    common_args(p)
    p.add_argument("--branches", default="All")
    p.add_argument("--pvalue", type=float, default=0.1)

    p = sub.add_parser("fmm", help="FitMultiModel: double/triple-hit codon model comparison")
    common_args(p)

    p = sub.add_parser("leisr", help="Per-site relative evolutionary rates (Rate4Site-like)")
    common_args(p)
    p.add_argument("--type", dest="datatype", default="nucleotide",
                   choices=["nucleotide", "protein"])
    p.add_argument("--model", default="GTR", help="GTR/HKY85/JC69 or LG/WAG/JTT/...")

    p = sub.add_parser("fade",
                       help="FUBAR Approach to Directional Evolution (protein, rooted tree)")
    common_args(p)
    p.add_argument("--branches", default="All")
    p.add_argument("--model", default="WAG")
    p.add_argument("--grid", type=int, default=20)
    p.add_argument("--method", dest="posterior_method", default="Variational-Bayes",
                   choices=["Variational-Bayes", "Collapsed-Gibbs", "Metropolis-Hastings"])
    p.add_argument("--concentration_parameter", type=float, default=0.5)

    p = sub.add_parser("bgm", help="Bayesian Graphical Model detection of co-evolving sites")
    common_args(p)
    p.add_argument("--branches", default="All")
    p.add_argument("--steps", type=int, default=100000)
    p.add_argument("--burn-in", dest="burnin", type=int, default=10000)
    p.add_argument("--samples", type=int, default=100)
    p.add_argument("--max-parents", dest="max_parents", type=int, default=1)
    p.add_argument("--min-subs", dest="min_subs", type=int, default=1)

    p = sub.add_parser("gard", help="Genetic Algorithm for Recombination Detection")
    p.add_argument("--alignment", required=True)
    p.add_argument("--output", default=None)
    p.add_argument("--max-breakpoints", dest="max_breakpoints", type=int, default=10)
    p.add_argument("--checkpoint", default=None, help="resumable cache JSON")
    return parser


def _read_tree_arg(tree):
    if tree is not None and os.path.exists(tree):
        with open(tree) as fh:
            return fh.read().strip()
    return tree


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.method == "warmup":
        sub_argv = [args.target] + list(args.rest)
        # the capped run writes its (meaningless) JSON to a .warmup path so
        # a real result file is never clobbered
        if "--output" not in sub_argv:
            try:
                aln = sub_argv[sub_argv.index("--alignment") + 1]
                sub_argv += ["--output", f"{aln}.{args.target.upper()}.warmup.json"]
            except (ValueError, IndexError):
                pass
        t0 = time.time()
        settings.warmup = True
        try:
            rc = main(sub_argv)
        finally:
            settings.warmup = False
        print(f"warmup complete in {time.time() - t0:.1f}s: '{args.target}' ran "
              f"with capped optimizers on these inputs")
        return rc

    if args.method == "error-filter":
        from hyphy_tpu_torch.methods import error_filter

        out_json = args.output_json or (args.json + ".filter.json")
        result = error_filter.run(args.json, output=args.output, output_json=out_json,
                                  threshold=args.threshold, ratio=args.ratio,
                                  site_threshold=args.site_threshold)
        print(f"Masked {result.total_masked} site x sequence cells; "
              f"filtered MSA written to {args.output}")
        return 0
    if args.method == "clade-support":
        from hyphy_tpu_torch.methods import clade_support

        out = args.output or (args.json + ".ECB.json")
        result = clade_support.run(args.json, output_json=out)
        print(f"ECB written to {out}: perplexity {result.perplexity}")
        return 0

    tree = _read_tree_arg(getattr(args, "tree", None))
    t0 = time.time()
    if args.method == "fel":
        from hyphy_tpu_torch.methods import fel

        result = fel.run(args.alignment, args.code, tree, args.branches,
                         srv=_bool(args.srv), pvalue=args.pvalue,
                         resample=args.resample,
                         multiple_hits=args.multiple_hits,
                         site_multihit=args.site_multihit,
                         ci=_bool(args.ci))
    elif args.method == "slac":
        from hyphy_tpu_torch.methods import slac

        result = slac.run(args.alignment, args.code, tree, args.branches,
                          pvalue=args.pvalue, samples=args.samples)
    elif args.method == "meme":
        from hyphy_tpu_torch.methods import meme

        result = meme.run(args.alignment, args.code, tree, args.branches,
                          pvalue=args.pvalue, rate_classes=args.rates,
                          resample=args.resample,
                          multiple_hits=args.multiple_hits,
                          site_multihit=args.site_multihit)
    elif args.method in ("fubar", "b-still"):
        from hyphy_tpu_torch.methods import bstill, fubar

        options = dict(grid_points=args.grid, method=args.posterior_method,
                       concentration=args.concentration_parameter)
        if args.method == "b-still":
            options.update(non_zero=_bool(args.non_zero), ebf_threshold=args.ebf,
                           radius_threshold=args.radius_threshold)
        module = fubar if args.method == "fubar" else bstill
        result = module.run(args.alignment, args.code, tree, args.branches, **options)
    elif args.method in ("contrast-fel", "contrast-meme"):
        from hyphy_tpu_torch.methods import contrast_fel, contrast_meme

        options = dict(test_labels=args.branch_sets, srv=_bool(args.srv),
                       pvalue=args.pvalue, qvalue=args.qvalue)
        if args.method == "contrast-meme":
            result = contrast_meme.run(args.alignment, args.code, tree,
                                       permutations=args.permutations, **options)
        else:
            result = contrast_fel.run(args.alignment, args.code, tree, **options)
    elif args.method in ("busted", "busted-ph"):
        from hyphy_tpu_torch.methods import busted, bustedph

        # the JAX CLI forces at least 2 starting points (hyphy_tpu/cli.py:331)
        options = dict(srv=_bool(args.srv), rate_classes=args.rates,
                       srv_classes=args.syn_rates,
                       starting_points=max(args.starting_points, 2),
                       multiple_hits=args.multiple_hits, error_sink=args.error_sink)
        if args.method == "busted":
            result = busted.run(args.alignment, args.code, tree, args.branches,
                                save_fit=args.save_fit, srv_hmm=args.srv_hmm,
                                srv_branchsite=args.srv_branchsite, **options)
        else:
            result = bustedph.run(args.alignment, args.code, tree, args.branches, **options)
    elif args.method == "relax":
        from hyphy_tpu_torch.methods import relax

        if args.groups:
            result = relax.run(args.alignment, args.code, tree, reference=args.reference,
                               rate_classes=args.rates,
                               groups=[g.strip() for g in args.groups.split(",")])
        else:
            if not args.test:
                raise SystemExit("relax: --test is required (or use --groups)")
            result = relax.run(args.alignment, args.code, tree, test=args.test,
                               reference=args.reference, rate_classes=args.rates,
                               models=args.models)
    elif args.method == "absrel":
        from hyphy_tpu_torch.methods import absrel

        result = absrel.run(args.alignment, args.code, tree, args.branches, pvalue=args.pvalue,
                            multiple_hits=args.multiple_hits, srv=_bool(args.srv),
                            srv_classes=args.syn_rates)
    elif args.method == "prime":
        from hyphy_tpu_torch.methods import prime

        result = prime.run(args.alignment, args.code, tree, args.branches, pvalue=args.pvalue)
    elif args.method == "fmm":
        from hyphy_tpu_torch.methods import fmm

        result = fmm.run(args.alignment, args.code, tree)
    elif args.method == "leisr":
        from hyphy_tpu_torch.methods import leisr

        result = leisr.run(args.alignment, datatype=args.datatype, model=args.model, tree=tree)
    elif args.method == "fade":
        from hyphy_tpu_torch.methods import fade

        result = fade.run(args.alignment, model=args.model, tree=tree, branches=args.branches,
                          grid_points=args.grid, method=args.posterior_method,
                          concentration=args.concentration_parameter)
    elif args.method == "bgm":
        from hyphy_tpu_torch.methods import bgm

        result = bgm.run(args.alignment, tree, args.code, args.branches, steps=args.steps,
                         burnin=args.burnin, samples=args.samples,
                         max_parents=args.max_parents, min_subs=args.min_subs)
    elif args.method == "gard":
        from hyphy_tpu_torch.methods import gard

        result = gard.run(args.alignment, max_breakpoints=args.max_breakpoints,
                          checkpoint=args.checkpoint)
    else:
        from hyphy_tpu_torch.methods import simulate

        result = simulate.run(args.alignment, args.code, tree, args.branches,
                              replicates=args.replicates, sites=args.sites,
                              omega=args.sim_omega, seed=args.seed,
                              output=(args.output.rsplit(".json", 1)[0]
                                      if args.output else None))
    out_path = args.output or f"{args.alignment}.{args.method.upper()}.json"
    result.json.setdefault("timers", {})["Total time"] = {
        "timer": round(time.time() - t0, 2), "order": 0,
    }
    write_json(result.json, out_path)
    print(f"Analysis complete. Results written to {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
