"""Command-line interface: ``python -m tpu21cmvae_torch <command>`` (the
port of ``tpu21cmvae/__main__.py``, with the same commands, flags and
outputs).

    train      train a model family (direct / ae / vae / ensemble), save it
    evaluate   test-set error table for a saved model
    predict    emulate signals for parameter rows from a .npy/.csv file
    export-h5  write a saved model's MLP weights as Keras-layout HDF5
    export-artifact  a self-contained torch.export program (predict,
               loglik or value+gradient) that replays without this package
    verify     accuracy-contract battery with a JSON report
    serve      saved model behind HTTP (JSON /predict, /loglik, /sample, …)
    sample     posterior sampling for an observed spectrum (chain .npz)
    fit        multi-start maximum-likelihood fit (.npz)
    advi       full-rank Gaussian ADVI over the value+gradient path
    profile    profile likelihood of one parameter, Wilks 68/95% intervals
    evidence   Bayesian evidence (nested, SMC, Laplace, flow, ladder; a
               multi-observation file runs the batched khat escalation)
    sbc        simulation-based calibration (rank uniformity)
    gof        posterior predictive goodness of fit of a sampled chain
    download   (refused: the port fetches nothing)
    tune       (refused: waits for the port of the architecture search)

Every command that loads or trains a model takes ``--device`` (default
``cuda``): on a CUDA device the kernels run, and without one the command
exits non-zero; it never falls back to the CPU. ``--device cpu`` runs
the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _device(args):
    """``--device`` as a torch.device; a CUDA device that is not there ends
    the command (exit 2), never a fall back to the CPU."""
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device is visible (torch.cuda.is_available() "
              "is False); pass --device cpu to run on the CPU", file=sys.stderr)
        raise SystemExit(2)
    return dev


def _get_data(args):
    from tpu21cmvae_torch.data.dataset import ensure_dataset, load_dataset
    from tpu21cmvae_torch.data.synthetic import synthetic_dataset

    if getattr(args, "dataset", None):
        return load_dataset(args.dataset)
    if getattr(args, "download", False):
        return ensure_dataset()
    print(
        "WARNING: no --dataset/--download given — using the built-in "
        "SYNTHETIC dataset. Results are not 21cmGEM numbers.",
        file=sys.stderr,
    )
    return synthetic_dataset(n_train=4096, n_val=512, n_test=512, seed=0)


def cmd_download(args):
    from tpu21cmvae_torch.data.dataset import default_cache_path

    print("download: the port fetches nothing (no network). Put dataset_21cmVAE.h5 at "
          f"{args.out or default_cache_path()} (or pass --dataset PATH); "
          "tpu21cmvae_torch.data.dataset.ensure_dataset reads it from there, and "
          "--download reads it too", file=sys.stderr)
    return 2


def cmd_tune(args):
    print("tune: the architecture search waits for the port of tpu21cmvae/tuner.py; "
          "run `python -m tpu21cmvae tune` for it", file=sys.stderr)
    return 2


def cmd_train(args):
    import dataclasses

    from tpu21cmvae_torch import AutoEncoderEmulator, DirectEmulator, VAEEmulator
    from tpu21cmvae_torch.utils.config import DIRECT_TRAIN_DEFAULT

    dev = _device(args)
    data = _get_data(args)
    cfg = DIRECT_TRAIN_DEFAULT
    if args.epochs:
        cfg = dataclasses.replace(cfg, epochs=args.epochs)
    if args.family == "ensemble":
        from tpu21cmvae_torch.models.ensemble import DeepEnsemble

        model = DeepEnsemble.train(data, n_members=args.members, train_config=cfg,
                                   verbose=True, device=dev)
    elif args.family == "direct":
        model = DirectEmulator(data, device=dev)
        model.train(train_config=cfg, verbose=True, checkpoint_dir=args.checkpoint_dir,
                    resume=args.checkpoint_dir is not None)
    else:
        cls = AutoEncoderEmulator if args.family == "ae" else VAEEmulator
        model = cls(data, device=dev)
        model.train(epochs=args.epochs, verbose=True, checkpoint_dir=args.checkpoint_dir,
                    resume=args.checkpoint_dir is not None)
    err = model.test_error()
    print(f"test error: mean {err.mean():.4f}% median {np.median(err):.4f}%")
    model.save(args.out)
    print(f"saved {args.out}")


def _load_model(args, data=None):
    from tpu21cmvae_torch.models import load_model

    return load_model(args.model, data, device=_device(args))


def _one_obs(args):
    """The single observation of ``--obs``, or None after printing why."""
    from tpu21cmvae_torch.serve import load_obs_specs

    specs = load_obs_specs(args.obs)
    if len(specs) != 1:
        print(f"--obs file must contain exactly one observation; got {len(specs)}",
              file=sys.stderr)
        return None
    return specs[0]


def _report_launches(model, wrapper):
    """On the kernel backend, print the launches of ``wrapper()``: the
    memoized kernel wrapper the entry point just ran."""
    pick = getattr(model, "_backend", None)
    if callable(pick) and pick() == "kernel":
        print(f"kernel launches: {wrapper().launches}")


def cmd_evaluate(args):
    data = _get_data(args)
    model = _load_model(args, data)
    for relative, unit in ((True, "%"), (False, "mK")):
        err = model.test_error(relative=relative)
        print(
            f"{'relative' if relative else 'absolute'}: "
            f"mean {err.mean():.4f}{unit} median {np.median(err):.4f}{unit} "
            f"max {err.max():.4f}{unit}"
        )


def cmd_predict(args):
    model = _load_model(args)
    raw = (np.loadtxt(args.params, delimiter=",") if args.params.endswith(".csv")
           else np.load(args.params))
    pred = model.predict(raw)
    np.save(args.out, pred)
    print(f"emulated {np.atleast_2d(pred).shape[0]} signal(s) → {args.out}")


def cmd_export_h5(args):
    import os

    from tpu21cmvae_torch.models.io_keras import save_keras_mlp

    model = _load_model(args)
    act = model.config.activation
    base, _ = os.path.splitext(args.out)
    if hasattr(model, "members"):  # DeepEnsemble: one h5 per member
        for i, m in enumerate(model.members):
            path = f"{base}_member_{i:02d}.h5"
            save_keras_mlp(path, m.params, activation=act)
            print(f"wrote {path}")
    elif hasattr(model, "em_params"):  # two-stage families: one file per stage MLP
        parts = ({"em": model.em_params, "dec": model.autoencoder.dec_params,
                  "enc": model.autoencoder.enc_params}
                 if hasattr(model, "autoencoder")
                 else {"em": model.em_params, "dec": model.vae.params["dec"]})
        for name, params in parts.items():
            path = f"{base}_{name}.h5"
            save_keras_mlp(path, params, activation=act, name=name)
            print(f"wrote {path}")
    else:
        save_keras_mlp(args.out, model.params, activation=act)
        print(f"wrote {args.out}")


def cmd_export_artifact(args):
    import os

    from tpu21cmvae_torch import deploy

    model = _load_model(args)
    platforms = None
    if args.platforms is not None:
        platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip())
        if not platforms or not set(platforms) <= set(deploy.PLATFORMS):
            bad = sorted(set(platforms) - set(deploy.PLATFORMS)) or ["(empty)"]
            print(f"--platforms must be a comma-separated subset of "
                  f"{sorted(deploy.PLATFORMS)}; got {','.join(bad)}", file=sys.stderr)
            return 2
    if args.obs is not None:
        spec = _one_obs(args)
        if spec is None:
            return 2
        export = deploy.export_valgrad if args.valgrad else deploy.export_loglik
        exported = export(model, *spec, platforms=platforms)
        kind = "value+gradient" if args.valgrad else "loglik"
    elif args.valgrad:
        print("--valgrad needs --obs (the likelihood is per-observation)", file=sys.stderr)
        return 2
    else:
        exported, kind = deploy.export_predict(model, platforms=platforms), "predict"
    path = deploy.save_artifact(exported, args.out)
    print(f"wrote {kind} artifact {path} ({os.path.getsize(path)} bytes, "
          f"platforms {','.join(exported.platforms)})")


def cmd_serve(args):
    from tpu21cmvae_torch.serve import main as serve_main

    serve_main(args.model, args.host, args.port, args.warmup, warmup_obs=args.warmup_obs,
               device=_device(args))


def _apply_noise_marginals(model, args, noise_var):
    """The observation's noise spec wrapped per the flags: --fg-terms →
    foreground-marginalized, --marginalize-noise-scale → level-
    marginalized on top."""
    if getattr(args, "fg_terms", None) is not None:
        noise_var = model.marginalize_foreground(noise_var, n_terms=args.fg_terms,
                                                 basis=args.fg_basis,
                                                 prior_var=args.fg_prior_var)
    if getattr(args, "marginalize_noise_scale", False):
        from tpu21cmvae_torch.noisescale import marginalize_noise_scale

        noise_var = marginalize_noise_scale(noise_var, alpha=args.noise_alpha,
                                            beta=args.noise_beta)
    return noise_var


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to load or train the model on (default cuda: "
                        "the kernels; exits non-zero without a CUDA device, never "
                        "falling back; cpu runs the plain versions)")


def _add_fg_args(p):
    p.add_argument("--fg-terms", type=int, default=None, metavar="K",
                   help="marginalize a K-term linear foreground out of the likelihood "
                        "analytically (tpu21cmvae_torch.foregrounds)")
    p.add_argument("--fg-basis", choices=["linlog", "powerlaw", "polynomial"],
                   default="linlog",
                   help="foreground family: linlog (Hills et al. 2018, default), "
                        "powerlaw (EDGES-style linearized), or polynomial (Legendre)")
    p.add_argument("--fg-prior-var", type=float, default=None,
                   help="Gaussian prior variance per foreground coefficient (default: "
                        "improper flat prior)")
    p.add_argument("--marginalize-noise-scale", action="store_true",
                   help="treat --noise-var as the noise SHAPE only and marginalize the "
                        "absolute level out of the likelihood (tpu21cmvae_torch.noisescale)")
    p.add_argument("--noise-alpha", type=float, default=None,
                   help="InvGamma prior alpha on the noise-level multiplier")
    p.add_argument("--noise-beta", type=float, default=None,
                   help="InvGamma prior beta on the noise-level multiplier")


def _build_prior(specs):
    """``--prior IDX:MEAN:SIGMA`` (repeatable) → GaussianBoxPrior over the
    default box, or None when no spec was given."""
    if not specs:
        return None
    from tpu21cmvae_torch.priors import GaussianBoxPrior

    constraints = {}
    for spec in specs:
        try:
            idx, mean, sigma = spec.split(":")
            constraints[int(idx)] = (float(mean), float(sigma))
        except ValueError:
            raise SystemExit(
                f"--prior expects IDX:MEAN:SIGMA (e.g. 3:0.054:0.006); got {spec!r}"
            )
    return GaussianBoxPrior.for_params(constraints)


def _log_prior(prior):
    return None if prior is None else prior.log_prior


def cmd_sample(args):
    model = _load_model(args)
    spec = _one_obs(args)
    if spec is None:
        return 2
    obs, noise_var = spec
    noise_var = _apply_noise_marginals(model, args, noise_var)
    if args.sampler == "smc":
        # the SMC anneal self-schedules: no steps/warmup/thin knobs
        kwargs = dict(n_particles=args.walkers, seed=args.seed)
    else:
        kwargs = dict(n_walkers=args.walkers, n_steps=args.steps, n_warmup=args.warmup,
                      thin=args.thin, seed=args.seed)
    prior = _build_prior(args.prior)
    if prior is not None:
        kwargs["log_prior"] = prior.log_prior
    if args.sampler == "hmc":
        kwargs["n_leapfrog"] = args.leapfrog
    elif args.sampler == "chees":
        if args.max_leapfrog is not None:
            kwargs["max_leapfrog"] = args.max_leapfrog
    elif args.sampler == "nuts":
        kwargs["max_depth"] = args.max_depth
    if args.sampler in ("hmc", "chees", "nuts"):
        kwargs["metric"] = args.metric
    elif args.sampler == "pt":
        kwargs["n_rungs"] = args.rungs
    if args.target_ess is not None:
        if args.sampler != "mh":
            print("--target-ess requires --sampler mh", file=sys.stderr)
            return 2
        kwargs["target_ess"] = args.target_ess
    res = model.sample_posterior(obs, noise_var, sampler=args.sampler, **kwargs)
    _report_launches(model, lambda: model._hmc_valgrad(obs, noise_var)
                     if args.sampler in ("hmc", "chees", "nuts")
                     else model.loglik_fn(obs, noise_var, backend="kernel"))
    print(res.summary(getattr(model, "par_labels", None)))
    if args.sampler == "smc":
        np.savez_compressed(
            args.out, final=res.final, logp=res.logp, logz=res.logz, logz_err=res.logz_err,
            betas=res.betas, stage_ess=res.stage_ess, accept_rate=res.accept_rate,
        )
        print(f"wrote {args.out} (particles {res.final.shape}, log Z = {res.logz:.4f})")
        return 0
    blob = dict(chain=res.chain, final=res.final, logp=res.logp,
                accept_rate=res.accept_rate, step_size=res.step_size)
    if getattr(res, "trajectory_length", None):  # ChEES diagnostics
        blob["trajectory_length"] = res.trajectory_length
    if getattr(res, "swap_rate", None) is not None:  # PT diagnostics
        blob["swap_rate"] = res.swap_rate
        blob["betas"] = res.betas
        if res.swap_rate.min() < 0.05:
            print(f"WARNING: min per-edge swap rate {res.swap_rate.min():.3f} — the ladder "
                  "barely transports; add --rungs or lower beta_min")
    if getattr(res, "mean_leapfrog", None):  # NUTS diagnostics
        blob["divergence_rate"] = res.divergence_rate
        blob["mean_leapfrog"] = res.mean_leapfrog
    np.savez_compressed(args.out, **blob)
    print(f"wrote {args.out} (chain {res.chain.shape}, final {res.final.shape})")
    return 0


def cmd_fit(args):
    model = _load_model(args)
    spec = _one_obs(args)
    if spec is None:
        return 2
    obs, noise_var = spec
    noise_var = _apply_noise_marginals(model, args, noise_var)
    prior = _build_prior(args.prior)
    res = model.fit_params(obs, noise_var, n_starts=args.starts, n_steps=args.steps,
                           learning_rate=args.lr, seed=args.seed, log_prior=_log_prior(prior))
    _report_launches(model, lambda: model._hmc_valgrad(obs, noise_var))
    print(res.summary(getattr(model, "par_labels", None)))
    np.savez_compressed(args.out, params=res.params, logp=res.logp, best=res.best,
                        best_logp=res.best_logp)
    print(f"wrote {args.out} ({res.params.shape[0]} starts)")
    return 0


def cmd_advi(args):
    model = _load_model(args)
    spec = _one_obs(args)
    if spec is None:
        return 2
    obs, noise_var = spec
    noise_var = _apply_noise_marginals(model, args, noise_var)
    prior = _build_prior(args.prior)
    res = model.fit_advi(obs, noise_var, n_steps=args.steps, n_mc=args.mc,
                         learning_rate=args.lr, seed=args.seed, log_prior=_log_prior(prior))
    _report_launches(model, lambda: model._hmc_valgrad(obs, noise_var))
    labels = getattr(model, "par_labels", [f"p{i}" for i in range(res.mu.shape[0])])
    mean, std = res.mean(), res.std()
    for lab, m, s in zip(labels, mean, std):
        print(f"  {lab:>8}: {m:12.6g} ± {s:.4g}")
    print(f"ELBO: first {res.elbo[0]:.4g} → last {res.elbo[-1]:.4g} "
          f"(tail std {res.elbo[-50:].std():.3g})")
    np.savez_compressed(args.out, mu=res.mu, chol=res.chol, elbo=res.elbo,
                        samples=res.sample(args.samples, seed=args.seed), mean=mean, std=std)
    print(f"wrote {args.out} ({args.samples} posterior draws)")
    return 0


def cmd_profile(args):
    from tpu21cmvae_torch.data.synthetic import PAR_RANGES

    model = _load_model(args)
    spec = _one_obs(args)
    if spec is None:
        return 2
    obs, noise_var = spec
    noise_var = _apply_noise_marginals(model, args, noise_var)
    n_params = model.config.n_params
    if not 0 <= args.index < n_params:
        print(f"--index must be in [0, {n_params}); got {args.index}", file=sys.stderr)
        return 2
    lo, hi = float(PAR_RANGES[args.index, 0]), float(PAR_RANGES[args.index, 1])
    grid = np.linspace(lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo), args.points)
    res = model.profile_likelihood(obs, noise_var, args.index, grid, n_starts=args.starts,
                                   n_steps=args.steps, seed=args.seed)
    _report_launches(model, lambda: model._hmc_valgrad(obs, noise_var))
    labels = getattr(model, "par_labels", None)
    name = labels[args.index] if labels else f"p{args.index}"
    i68, i95 = res.interval(0.68), res.interval(0.95)
    print(f"profile likelihood of {name}: peak at {res.grid[res.logl.argmax()]:.6g}")
    print(f"  68% interval: [{i68[0]:.6g}, {i68[1]:.6g}]")
    print(f"  95% interval: [{i95[0]:.6g}, {i95[1]:.6g}]")
    if i95[0] == res.grid[0] or i95[1] == res.grid[-1]:
        print("  (an endpoint equals the grid edge: interval censored by the scanned range)")
    np.savez_compressed(args.out, index=res.index, grid=res.grid, logl=res.logl,
                        params=res.params, interval68=i68, interval95=i95)
    print(f"wrote {args.out}")
    return 0


def _cmd_evidence_batch(model, specs, args):
    """``evidence`` on a multi-observation spec file: one batched Laplace
    + IS sweep with the khat escalation (``--method auto|laplace|flow``,
    ``--final nested|smc``), all observations under one noise spec."""
    if not specs:
        print("--obs file contains no observations", file=sys.stderr)
        return 2
    if args.method not in ("auto", "laplace", "flow"):
        print(f"--method {args.method} is per-observation only; a multi-observation spec "
              "runs the batched pipeline (--method auto|laplace|flow, optionally --final "
              "nested|smc for the still-failing rows)", file=sys.stderr)
        return 2
    nv0 = specs[0][1]
    for i, (_, nv) in enumerate(specs[1:], 1):
        if not np.array_equal(np.asarray(nv0), np.asarray(nv)):
            print(f"batched evidence needs ONE shared noise spec; observation {i} differs "
                  "from observation 0 — run per-observation `evidence` calls instead",
                  file=sys.stderr)
            return 2
    try:
        obs_batch = np.stack([o for o, _ in specs])
    except ValueError as e:
        print(f"observations do not stack into one batch ({e}); every row must have the "
              "same length", file=sys.stderr)
        return 2
    prior = _build_prior(args.prior)
    noise_var = _apply_noise_marginals(model, args, nv0)
    lap_kw = {}
    if args.fit_starts is not None:
        lap_kw["n_starts"] = args.fit_starts
    if args.fit_steps is not None:
        lap_kw["n_steps"] = args.fit_steps
    final_kwargs = None
    if args.final == "nested":
        final_kwargs = {"n_live": args.live, "n_mh": args.mh_steps}
        if prior is not None:
            final_kwargs["prior_transform"] = prior.prior_transform
    elif args.final == "smc":
        final_kwargs = {"n_particles": args.walkers * 8}
    res = model.log_evidence_batch(obs_batch, noise_var, method=args.method, final=args.final,
                                   final_kwargs=final_kwargs, seed=args.seed,
                                   log_prior=_log_prior(prior), **lap_kw)
    rows = []
    print(f"{'row':>4} {'logz':>12} {'err':>8} {'khat':>6} method")
    for i, r in enumerate(res):
        k = f"{r.khat:.2f}" if np.isfinite(r.khat) else "—"
        print(f"{i:>4} {r.logz:>12.4f} {r.logz_err:>8.4f} {k:>6} {r.method_used}")
        rows.append((r.logz, r.logz_err, r.khat))
    arr = np.asarray(rows)
    np.savez_compressed(
        args.out, logz=arr[:, 0], logz_err=arr[:, 1], khat=arr[:, 2],
        method_used=np.asarray([r.method_used for r in res]),
        map_params=np.stack([r.map_params for r in res]),
    )
    bad = [i for i, r in enumerate(res)
           if r.method_used in ("laplace", "flow") and not (r.khat < 0.7)]
    truncated = [i for i in bad if res[i].final_result is not None]
    bad = [i for i in bad if res[i].final_result is None]
    if truncated:
        print(f"WARNING: rows {truncated} ran the final nested stage but it TRUNCATED (logz "
              "would only be a lower bound, so it was not adopted) — raise --live or nested "
              "max_iters for these rows", file=sys.stderr)
    if bad:
        hint = ("rerun with --final nested" if args.final is None
                else "raise the flow/nested budgets for these rows")
        print(f"WARNING: rows {bad} end with khat >= 0.7 and no definitive estimate — {hint}",
              file=sys.stderr)
    print(f"wrote {args.out} ({len(res)} evidences)")
    return 0


def cmd_evidence(args):
    from tpu21cmvae_torch.serve import load_obs_specs

    model = _load_model(args)
    specs = load_obs_specs(args.obs)
    if len(specs) != 1:
        return _cmd_evidence_batch(model, specs, args)
    obs, noise_var = specs[0]
    if args.method == "auto":
        print("--method auto is the BATCHED escalation policy; a single-observation spec "
              "picks an explicit estimator (nested/smc/laplace/flow/ladder)", file=sys.stderr)
        return 2
    if args.final is not None:
        print("--final is the batched pipeline's definitive last stage; on a single "
              f"observation just run --method {args.final} directly", file=sys.stderr)
        return 2
    noise_var = _apply_noise_marginals(model, args, noise_var)
    prior = _build_prior(args.prior)
    if args.method == "nested":
        res = model.log_evidence(
            obs, noise_var, method="nested", n_live=args.live, n_mh=args.mh_steps,
            seed=args.seed, prior_transform=None if prior is None else prior.prior_transform,
        )
        print(res.summary())
        np.savez_compressed(args.out, logz=res.logz, logz_err=res.logz_err, h=res.h,
                            samples=res.samples, logl=res.logl, log_w=res.log_w,
                            posterior=res.posterior(4096, seed=args.seed))
    elif args.method == "smc":
        res = model.log_evidence(obs, noise_var, method="smc", n_particles=args.walkers * 8,
                                 seed=args.seed, log_prior=_log_prior(prior))
        print(f"SMC: log Z = {res.logz:.4f} +- {res.logz_err:.4f} ({res.n_stages} stages, "
              f"mean mutation acceptance {res.accept_rate.mean():.3f})")
        np.savez_compressed(args.out, logz=res.logz, logz_err=res.logz_err, betas=res.betas,
                            stage_ess=res.stage_ess, accept_rate=res.accept_rate,
                            posterior=res.final, logp=res.logp)
    elif args.method == "laplace":
        kw = {}
        if args.fit_starts is not None:
            kw["n_starts"] = args.fit_starts
        if args.fit_steps is not None:
            kw["n_steps"] = args.fit_steps
        res = model.log_evidence(obs, noise_var, method="laplace", seed=args.seed,
                                 log_prior=_log_prior(prior), **kw)
        print(res.summary(getattr(model, "par_labels", None)))
        np.savez_compressed(args.out, logz=res.logz, map_params=res.map_params,
                            map_logp=res.map_logp, cov=res.cov, pd=res.pd,
                            posterior=res.posterior(4096, seed=args.seed))
    elif args.method == "flow":
        kw = {}
        if args.fit_steps is not None:
            kw["n_steps"] = args.fit_steps
        res = model.log_evidence(obs, noise_var, method="flow", seed=args.seed,
                                 log_prior=_log_prior(prior), **kw)
        print(res.summary())
        np.savez_compressed(args.out, logz=res.logz, logz_err=res.logz_err, khat=res.khat,
                            is_ess=res.is_ess, posterior=res.posterior(4096, seed=args.seed))
    else:
        res = model.log_evidence(obs, noise_var, method="ladder", n_rungs=args.rungs,
                                 n_walkers=args.walkers, n_steps=args.steps,
                                 n_warmup=args.warmup, seed=args.seed,
                                 log_prior=_log_prior(prior))
        print(res.summary())
        np.savez_compressed(args.out, logz=res.logz, logz_err=res.logz_err,
                            ladder_drift=res.ladder_drift, rung_logz=res.rung_logz,
                            betas=res.betas, accept_rate=res.accept_rate,
                            swap_rate=res.swap_rate, posterior=res.posterior, logp=res.logp)
    print(f"wrote {args.out} (log Z = {res.logz:.4f})")
    return 0


def cmd_sbc(args):
    from tpu21cmvae_torch.calibration import sbc

    model = _load_model(args)
    res = sbc(model, n_sims=args.sims, n_walkers=args.walkers, n_steps=args.steps,
              n_warmup=args.warmup, noise_var=args.noise_var, seed=args.seed,
              prior=_build_prior(args.prior))
    print(res.summary(getattr(model, "par_labels", None)))
    np.savez_compressed(args.out, ranks=res.ranks, pvalues=res.pvalues, thetas=res.thetas,
                        n_posterior=res.n_posterior)
    print(f"wrote {args.out}")
    return 0 if (res.pvalues > 0.005).all() else 1


def cmd_gof(args):
    from tpu21cmvae_torch.calibration import goodness_of_fit

    model = _load_model(args)
    spec = _one_obs(args)
    if spec is None:
        return 2
    obs, noise_var = spec
    noise_var = _apply_noise_marginals(model, args, noise_var)
    blob = np.load(args.chain)
    if "chain" in blob and blob["chain"].size:
        draws = blob["chain"].reshape(-1, blob["chain"].shape[-1])
    else:
        draws = blob["final"]
    try:
        res = goodness_of_fit(model, obs, noise_var, draws, max_draws=args.max_draws,
                              seed=args.seed)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(res.summary())
    worst = int(np.argmax(np.abs(res.bin_z)))
    print(f"worst bin: index {worst} (z = {res.bin_z[worst]:+.2f})")
    return 0 if 0.01 < res.p_value < 0.99 else 1


def cmd_verify(args):
    from tpu21cmvae_torch.verify import format_report, run_verification, write_report

    dev = _device(args)
    data = _get_data(args)
    label = args.dataset or ("downloaded" if args.download else "synthetic")
    report = run_verification(data, direct_h5=args.direct_h5, keras_dir=args.keras_dir,
                              dataset_label=label, device=dev)
    print(format_report(report))
    if args.out:
        write_report(report, args.out)
        print(f"report written to {args.out}")
    if not report["ok"]:
        sys.exit(1)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpu21cmvae_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("download", help="refused: the port fetches nothing (no network)")
    p.add_argument("--out")
    p.set_defaults(fn=cmd_download)

    p = sub.add_parser("train", help="train a model family")
    p.add_argument("family", choices=["direct", "ae", "vae", "ensemble"])
    p.add_argument("--dataset")
    p.add_argument("--download", action="store_true",
                   help="use the real dataset from the local cache (never fetched)")
    p.add_argument("--epochs", type=int)
    p.add_argument("--members", type=int, default=5, help="replica count for family=ensemble")
    p.add_argument("--out", default="model.npz",
                   help="checkpoint path (a DIRECTORY for family=ensemble)")
    p.add_argument("--checkpoint-dir")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="test-set error of a saved model")
    p.add_argument("model", help="checkpoint .npz, or a deep-ensemble directory")
    p.add_argument("--dataset")
    p.add_argument("--download", action="store_true")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("predict", help="emulate signals from parameter rows")
    p.add_argument("model")
    p.add_argument("params", help=".npy or .csv of (n, 7) parameter rows")
    p.add_argument("--out", default="signals.npy")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("export-h5", help="export a saved model as Keras-layout HDF5")
    p.add_argument("model")
    p.add_argument("--out", default="model.h5")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_export_h5)

    p = sub.add_parser(
        "export-artifact",
        help="export a self-contained torch.export program (weights and normalization "
             "folded in, dynamic batch dim; replays with torch alone, no tpu21cmvae_torch)",
    )
    p.add_argument("model")
    p.add_argument("--out", default="emulator.pt2")
    p.add_argument("--obs", default=None, metavar="FILE",
                   help="single-observation spec file (same formats as serve "
                        "--warmup-obs): export the log-likelihood for it instead of predict")
    p.add_argument("--valgrad", action="store_true",
                   help="with --obs: export the value+gradient likelihood")
    p.add_argument("--platforms", default=None,
                   help="comma-separated device types the artifact is checked to replay on "
                        "(cpu, cuda; default cpu and the model's device)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_export_artifact)

    p = sub.add_parser("serve", help="serve a saved model over HTTP (JSON /predict + /loglik)")
    p.add_argument("model")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--warmup", type=int, default=1024,
                   help="run every predict bucket up to this many rows before serving")
    p.add_argument("--warmup-obs", default=None, metavar="FILE",
                   help="also build and run the likelihood of the (obs, noise_var) specs in "
                        "FILE (.json or .npz — see tpu21cmvae_torch.serve.load_obs_specs)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("sample", help="posterior sampling (MH/ensemble/HMC/…) for an "
                                      "observed spectrum")
    p.add_argument("model", help="checkpoint .npz, or a deep-ensemble directory (chains "
                                 "then target the member-mixture likelihood)")
    p.add_argument("--obs", required=True, metavar="FILE",
                   help="observation spec (.json or .npz with obs and optional noise_var — "
                        "serve.load_obs_specs format, exactly one entry)")
    p.add_argument("--sampler", choices=["hmc", "chees", "nuts", "mh", "ensemble", "pt", "smc"],
                   default="hmc",
                   help="chees = HMC with adaptive trajectory length; nuts = batched "
                        "No-U-Turn; pt = parallel tempering (--rungs); smc = adaptive "
                        "tempered SMC (--walkers particles, log Z for free)")
    p.add_argument("--walkers", type=int, default=4096)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--leapfrog", type=int, default=8)
    p.add_argument("--max-leapfrog", type=int, default=None,
                   help="with --sampler chees: cap on the adapted leapfrog count")
    p.add_argument("--max-depth", type=int, default=6,
                   help="with --sampler nuts: tree-doubling cap")
    p.add_argument("--metric", choices=["auto", "dense", "diag"], default="auto",
                   help="gradient samplers' ensemble mass matrix (auto = dense for nuts, "
                        "diag for hmc and chees)")
    p.add_argument("--rungs", type=int, default=32, help="temperature-ladder size for pt")
    p.add_argument("--target-ess", type=float, default=None,
                   help="with --sampler mh: run chunks of --steps until the minimum "
                        "per-parameter ESS reaches this")
    p.add_argument("--thin", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prior", action="append", metavar="IDX:MEAN:SIGMA",
                   help="Gaussian prior on parameter IDX (repeatable; e.g. --prior "
                        "3:0.054:0.006); unlisted parameters stay flat over the box")
    p.add_argument("--out", default="chain.npz")
    _add_fg_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_sample)

    p = sub.add_parser("fit", help="multi-start maximum-likelihood parameter fit for an "
                                   "observed spectrum")
    p.add_argument("model")
    p.add_argument("--obs", required=True, metavar="FILE",
                   help="observation spec (.json or .npz, exactly one entry)")
    p.add_argument("--starts", type=int, default=1024)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prior", action="append", metavar="IDX:MEAN:SIGMA",
                   help="Gaussian prior on parameter IDX (repeatable): MAP instead of ML")
    p.add_argument("--out", default="fit.npz")
    _add_fg_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("advi", help="approximate posterior by full-rank Gaussian ADVI over "
                                    "the value+gradient path")
    p.add_argument("model")
    p.add_argument("--obs", required=True, metavar="FILE",
                   help="observation spec (.json or .npz, exactly one entry)")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--mc", type=int, default=512, help="Monte-Carlo draws per ELBO step")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--samples", type=int, default=4096, help="posterior draws saved to --out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prior", action="append", metavar="IDX:MEAN:SIGMA",
                   help="Gaussian prior on parameter IDX (repeatable)")
    p.add_argument("--out", default="advi.npz")
    _add_fg_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_advi)

    p = sub.add_parser("profile", help="profile likelihood of one parameter (Wilks 68/95%% "
                                       "confidence intervals from batched refits)")
    p.add_argument("model")
    p.add_argument("--obs", required=True, metavar="FILE",
                   help="observation spec (.json or .npz, exactly one entry)")
    p.add_argument("--index", type=int, required=True,
                   help="parameter index to profile (0-6; see par_labels)")
    p.add_argument("--points", type=int, default=41, help="grid points across the prior range")
    p.add_argument("--starts", type=int, default=256)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="profile.npz")
    _add_fg_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("evidence", help="Bayesian evidence (log Z) for an observed spectrum, "
                                        "for model comparison across families")
    p.add_argument("model")
    p.add_argument("--obs", required=True, metavar="FILE",
                   help="observation spec (.json or .npz; several entries run the batched "
                        "pipeline)")
    p.add_argument("--method", choices=("nested", "smc", "laplace", "flow", "ladder", "auto"),
                   default="nested",
                   help="nested (robust default), smc, laplace (exact-tier Gaussian quick "
                        "look, unimodal only), flow (flow importance sampling; trust it when "
                        "khat < 0.7), ladder (cross-check only), or auto (multi-observation "
                        "files only: batched Laplace + IS with khat-triggered flow "
                        "escalation; add --final for a definitive last stage)")
    p.add_argument("--final", choices=("nested", "smc"), default=None,
                   help="batched runs: settle rows still failing khat after the flow "
                        "attempt with a per-row definitive estimator")
    p.add_argument("--live", type=int, default=2048, help="nested: number of live points")
    p.add_argument("--mh-steps", type=int, default=24,
                   help="nested: constrained-MH steps per replacement")
    p.add_argument("--rungs", type=int, default=32)
    p.add_argument("--walkers", type=int, default=256)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--warmup", type=int, default=200)
    p.add_argument("--fit-starts", type=int, default=None,
                   help="laplace: MAP ascent starts (default 4096)")
    p.add_argument("--fit-steps", type=int, default=None,
                   help="laplace: MAP ascent steps (default 2000)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prior", action="append", metavar="IDX:MEAN:SIGMA",
                   help="Gaussian prior on parameter IDX (repeatable); log Z is then the "
                        "evidence under that prior")
    p.add_argument("--out", default="evidence.npz")
    _add_fg_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_evidence)

    p = sub.add_parser("sbc", help="simulation-based calibration of the sampler+likelihood "
                                   "stack (rank uniformity; exit 1 if any parameter rejects)")
    p.add_argument("model")
    p.add_argument("--sims", type=int, default=128)
    p.add_argument("--walkers", type=int, default=64,
                   help="per simulation; sets the rank resolution")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--warmup", type=int, default=400)
    p.add_argument("--noise-var", type=float, default=25.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prior", action="append", metavar="IDX:MEAN:SIGMA",
                   help="calibrate under a Gaussian prior (repeatable)")
    p.add_argument("--out", default="sbc.npz")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_sbc)

    p = sub.add_parser("gof", help="posterior predictive goodness-of-fit check of a sampled "
                                   "chain against its observation (exit 1 on misfit)")
    p.add_argument("model", help="checkpoint .npz or ensemble directory")
    p.add_argument("--obs", required=True, metavar="FILE",
                   help="observation spec (same format as sample --obs)")
    p.add_argument("--chain", required=True, metavar="FILE",
                   help="chain .npz written by the sample command")
    p.add_argument("--max-draws", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    _add_fg_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_gof)

    p = sub.add_parser("verify", help="run the accuracy-contract battery (golden numbers + "
                                      "batched-vs-single + band checks) and write a report")
    p.add_argument("--dataset", help="path to dataset_21cmVAE.h5")
    p.add_argument("--download", action="store_true")
    p.add_argument("--direct-h5", help="reference pretrained models/emulator.h5")
    p.add_argument("--keras-dir", help="dir with ae_emulator.h5/encoder.h5/decoder.h5")
    p.add_argument("--out", help="write the JSON report here")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("tune", help="refused: waits for the port of the architecture search")
    p.add_argument("--family", choices=["direct", "ae", "vae"], default="direct")
    p.add_argument("--trials", type=int, default=10)
    p.add_argument("--halving", action="store_true")
    p.add_argument("--dataset")
    p.add_argument("--download", action="store_true")
    p.set_defaults(fn=cmd_tune)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
