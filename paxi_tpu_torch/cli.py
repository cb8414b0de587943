"""Command-line entry points of the port (the JAX package's ``cli.py``:
the same subcommands, flags, JSON output and exit codes).

    python -m paxi_tpu_torch sim -algorithm paxos -groups 100000 \
        -replicas 5 -slots 64 -steps 104
    python -m paxi_tpu_torch profile | trace info|replay|shrink|host FILE |
        hunt run|status|report [--no-host] | scenario list|run [-host] |
        workload list|run | metrics --series | lint [PATHS]

Every subcommand that runs the sim takes ``-device``/``--device``: the
card by default, ``cpu`` to run on the CPU.  The host runtime (``trace
host``'s projection, ``scenario run -host`` and the hunt's host replay)
is asyncio Python on the CPU, as in the JAX package; it drives the host
twin of every protocol (``protocols._HOST_MODULES``).
``lint`` is the port's paxi-lint (``paxi_tpu_torch/analysis``): pure AST,
it needs no card.  Serving (``server``, ``client``, the metrics scrape)
and ``spans`` are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys


def _device_arg(sp) -> None:
    sp.add_argument("-device", "--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")


def _ints(metrics, skip=()) -> dict:
    return {k: int(v) for k, v in metrics.items()
            if not any(k.startswith(p) for p in skip)}


def cmd_sim(args) -> int:
    """The sim runtime: protocol fuzzing at scale."""
    from paxi_tpu_torch.profiling import chrome_trace
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FuzzConfig, SimConfig
    proto = sim_protocol(args.algorithm)
    cfg = SimConfig(n_replicas=args.replicas, n_slots=args.slots,
                    n_keys=args.keys, n_zones=args.zones)
    fuzz = FuzzConfig(p_drop=args.p_drop, p_dup=args.p_dup,
                      max_delay=args.max_delay,
                      p_crash=args.p_crash, p_partition=args.p_partition)
    with chrome_trace(args.profile):
        return _run_sim(args, proto, cfg, fuzz)


def _run_sim(args, proto, cfg, fuzz) -> int:
    from paxi_tpu_torch.sim import simulate
    if args.shard:
        # the ranks torchrun describes, else this process alone
        import os

        from paxi_tpu_torch import random as tr
        from paxi_tpu_torch.parallel import make_mesh, make_sharded_run
        if "WORLD_SIZE" in os.environ:
            import torch.distributed as dist
            from paxi_tpu_torch.parallel.launch import init_from_env
            mesh = init_from_env(args.device)
        else:
            dist, mesh = None, make_mesh(device=args.device)
        try:
            run = make_sharded_run(proto, cfg, fuzz=fuzz, mesh=mesh)
            _, metrics, viols = run(tr.PRNGKey(args.seed), args.groups,
                                    args.steps)
            out = _ints(metrics)
            out["invariant_violations"] = int(viols)
        finally:
            if dist is not None:
                dist.destroy_process_group()
        if mesh.rank != 0:
            return 0 if out["invariant_violations"] == 0 else 1
    else:
        res = simulate(proto, cfg, args.groups, args.steps, fuzz=fuzz,
                       seed=args.seed, device=args.device)
        out = _ints(res.metrics)
        out["invariant_violations"] = int(res.violations)
    out.update(algorithm=args.algorithm, groups=args.groups,
               steps=args.steps, replicas=args.replicas)
    print(json.dumps(out))
    return 0 if out["invariant_violations"] == 0 else 1


def cmd_profile(args) -> int:
    """Per-phase wall timings for a bench-shaped run (build, warm-up,
    best timed run), optionally a torch.profiler Chrome trace."""
    from paxi_tpu_torch.profiling import main_json
    from paxi_tpu_torch.sim import FuzzConfig
    fuzz = FuzzConfig(p_drop=args.p_drop, p_dup=args.p_dup,
                      max_delay=args.max_delay)
    return main_json(algorithm=args.algorithm, groups=args.groups,
                     steps=args.steps, replicas=args.replicas,
                     slots=args.slots, seed=args.seed,
                     shard=args.shard, repeats=args.repeats,
                     trace_dir=args.trace_dir, fuzz=fuzz,
                     device=args.device)


def cmd_trace(args) -> int:
    """Trace files: inspect, replay deterministically, minimize."""
    from paxi_tpu_torch import trace as tr
    t = tr.load(args.file)
    if args.trace_cmd == "info":
        print(json.dumps(dict(t.meta, steps=t.n_steps,
                              events=t.n_events())))
        return 0
    if args.trace_cmd == "replay":
        r = (tr.check_determinism(t, device=args.device) if args.twice
             else tr.replay(t, device=args.device))
        want = (t.meta.get("replay_state_hash")
                if t.meta.get("shrunk") else
                t.meta.get("capture_state_hash"))
        # a replay must reproduce the recorded whole-batch counters too,
        # over the recorded keys
        want_counts = t.meta.get("replay_counters"
                                 if t.meta.get("shrunk") else
                                 "capture_counters")
        counts_ok = (want_counts is None
                     or all(r.counters.get(k) == v
                            for k, v in want_counts.items()))
        ok = (r.violations == t.meta.get("group_violations", -1)
              and (want is None or r.state_hash == want)
              and counts_ok)
        print(json.dumps({
            "violations": r.violations,
            "first_violation_step": r.first_violation_step(),
            "state_hash": r.state_hash,
            "counters": r.counters,
            "reproduced": ok,
        }))
        return 0 if ok else 1
    if args.trace_cmd == "shrink":
        mini, stats = tr.shrink(t, max_trials=args.max_trials,
                                log=lambda m: print(f"# {m}", flush=True),
                                device=args.device)
        out = args.out or (args.file.removesuffix(".npz") + ".min")
        stats["out"] = tr.save(out, mini)
        print(json.dumps(stats))
        return 0
    if args.trace_cmd == "host":
        from paxi_tpu_torch.trace.host import (directives_json,
                                               host_directives, local_ids)
        cfg = t.sim_config()
        ids = local_ids(cfg.n_replicas, cfg.n_zones)
        if args.all:
            # this trace's projection coverage under every host-registry
            # protocol's TRACE_MSG_MAP: which protocols could replay the
            # schedule exactly, and what each one loses
            from paxi_tpu_torch.hunt.classify import coverage_of
            from paxi_tpu_torch.protocols import _HOST_MODULES
            from paxi_tpu_torch.trace.host import trace_msg_map
            out = {}
            for proto in sorted(_HOST_MODULES):
                m = trace_msg_map(proto)
                if not m:
                    continue
                out[proto] = coverage_of(t, ids=ids, msg_map=m)
            print(json.dumps({"trace_protocol": t.protocol,
                              "coverage": out}))
            return 0
        dirs, stats = host_directives(t, ids, step_s=args.step_ms / 1e3)
        payload = {"directives": directives_json(dirs), "stats": stats}
        if args.seq:
            from paxi_tpu_torch.trace.host import seq_schedule
            sched, sstats = seq_schedule(t, ids)
            payload["sequenced"] = sched.to_json()
            payload["seq_stats"] = sstats
        print(json.dumps(payload))
        return 0
    raise AssertionError(args.trace_cmd)


def cmd_hunt(args) -> int:
    """The divergence-hunting campaign engine."""
    from paxi_tpu_torch.hunt import Campaign

    try:
        camp = Campaign(args.dir or None,
                        protocols=(args.protocols.split(",")
                                   if args.protocols else None),
                        budget=args.budget, quick=args.quick,
                        shrink_trials=args.shrink_trials,
                        host_replay=(args.hunt_cmd == "run"
                                     and not args.no_host),
                        traces_dir=args.traces_dir or None,
                        log=(lambda m: None) if args.quiet else None,
                        device=args.device)
    except (KeyError, ValueError) as e:
        print(f"hunt: {e}", file=sys.stderr)
        return 2
    if args.hunt_cmd == "run":
        rep = camp.run()
        t = rep["summary"]["totals"]
        print(json.dumps(rep["summary"]))
        print(f"hunt: {t['runs']} runs, {t['witnesses']} witnesses "
              f"({t['reproduced']} reproduced, {t['diverged']} diverged, "
              f"{t['unmappable']} unmappable, "
              f"{t['unclassified']} unclassified) -> "
              f"{camp.root}/HUNT_REPORT.md", file=sys.stderr)
        return 2 if t["unclassified"] else 0
    if args.hunt_cmd == "status":
        print(json.dumps(camp.status()))
        return 0
    if args.hunt_cmd == "report":
        rep = camp.write_report()
        print(json.dumps(rep["summary"]))
        return 0
    raise AssertionError(args.hunt_cmd)


def cmd_scenario(args) -> int:
    """The WAN topology / churn / reconfiguration scenario engine: list
    the named catalog, or run one scenario on the sim."""
    from paxi_tpu_torch import scenarios as scn

    if args.scenario_cmd == "list":
        for name in sorted(scn.NAMED):
            print(json.dumps(scn.describe(scn.NAMED[name])))
        return 0
    assert args.scenario_cmd == "run"
    try:
        scenario = scn.named_scenario(args.scenario)
    except KeyError as e:
        print(f"scenario: {e.args[0]}", file=sys.stderr)
        return 2
    try:
        scenario.validate(args.replicas)
    except ValueError as e:
        print(f"scenario: {e}", file=sys.stderr)
        return 2

    from paxi_tpu_torch.sim import FuzzConfig, SimConfig
    cfg = SimConfig(n_replicas=args.replicas, n_slots=args.slots,
                    n_keys=args.keys, n_zones=args.zones,
                    n_objects=args.objects, locality=args.locality)
    # switchnet events compile into the static sim knobs, and ride into
    # the host replay's config, where the protocol's HUNT_FABRIC_SETUP
    # builds the matching switch tier
    cfg = scn.apply_switch(cfg, scenario)

    if args.host:
        # the scenario compiles into the virtual-clock fabric's fault
        # surface (standing per-edge WAN latencies, per-step crash sets)
        # and the hunt's replay core drives the host cluster under it;
        # the randomized-fault knobs are sim-only
        if args.p_drop or args.max_delay > 1:
            print("scenario: -p_drop/-max_delay apply to the sim "
                  "runtime only (the -host fabric runs the scenario's "
                  "deterministic schedule)", file=sys.stderr)
            return 2
        import asyncio

        from paxi_tpu_torch.host.simulation import chan_config
        from paxi_tpu_torch.hunt.classify import replay_schedule
        hcfg = chan_config(args.replicas, zones=args.zones,
                           tag="scenario")
        sched = scn.seq_schedule_of(scenario, hcfg.ids, args.steps)
        out = asyncio.run(replay_schedule(args.algorithm, cfg, sched,
                                          cfg=hcfg, seed=args.seed))
        payload = dict(out.to_json(), runtime="host",
                       algorithm=args.algorithm, scenario=scenario.name,
                       steps=args.steps)
        print(json.dumps(payload))
        return 0 if not out.violated else 1

    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import simulate
    proto = sim_protocol(args.algorithm)
    fuzz = scn.with_scenario(
        FuzzConfig(p_drop=args.p_drop, max_delay=args.max_delay),
        scenario)
    res = simulate(proto, cfg, args.groups, args.steps, fuzz=fuzz,
                   seed=args.seed, device=args.device)
    payload = _ints(res.metrics, skip=("commit_lat_",))
    payload.update(runtime="sim", algorithm=args.algorithm,
                   scenario=scenario.name, groups=args.groups,
                   steps=args.steps, replicas=args.replicas,
                   invariant_violations=int(res.violations))
    # the zone-latency split in mean lock-step rounds, where instrumented
    payload.update(scn.latency_split(res.metrics))
    print(json.dumps(payload))
    return 0 if payload["invariant_violations"] == 0 else 1


def cmd_workload(args) -> int:
    """The workload engine: list the named spec catalog, or run one spec
    on the sim and report the per-key-class latency split."""
    from paxi_tpu_torch import workload as wlmod

    if args.workload_cmd == "list":
        for name in sorted(wlmod.NAMED):
            print(json.dumps(wlmod.describe(wlmod.NAMED[name],
                                            n_keys=args.keys)))
        return 0
    assert args.workload_cmd == "run"
    try:
        wl = wlmod.named_workload(args.workload)
    except KeyError as e:
        print(f"workload: {e.args[0]}", file=sys.stderr)
        return 2

    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FuzzConfig, SimConfig, simulate
    cfg = SimConfig(n_replicas=args.replicas, n_slots=args.slots,
                    n_keys=args.keys, n_zones=args.zones,
                    n_objects=args.objects)
    try:
        cfg = wlmod.apply_workload(cfg, wl)
    except ValueError as e:
        print(f"workload: {e}", file=sys.stderr)
        return 2
    proto = sim_protocol(args.algorithm)
    fuzz = FuzzConfig(p_drop=args.p_drop, max_delay=args.max_delay)
    res = simulate(proto, cfg, args.groups, args.steps, fuzz=fuzz,
                   seed=args.seed, device=args.device)
    payload = _ints(res.metrics, skip=("commit_lat_",))
    payload.update(runtime="sim", algorithm=args.algorithm,
                   workload=wl.name, groups=args.groups,
                   steps=args.steps, replicas=args.replicas,
                   invariant_violations=int(res.violations))
    lat = res.latency_summary()
    if lat is not None:
        payload["commit_latency"] = {k: lat[k] for k in
                                     ("n", "p50_rounds", "p99_rounds")}
    payload["key_class_latency"] = {
        c: {k: s[k] for k in ("n", "mean_rounds", "p50_rounds",
                              "p99_rounds")}
        for c, s in wlmod.class_split(res.state).items()}
    print(json.dumps(payload))
    return 0 if payload["invariant_violations"] == 0 else 1


def cmd_metrics(args) -> int:
    """``--series``: run the sim and export the per-step counter time
    series (JSON, or CSV with ``-csv``).  Reading a live host node or a
    host artifact stays in the JAX package."""
    if not args.series:
        print("metrics: only --series is ported (the live /metrics scrape "
              "and the artifact walk read host output: python -m paxi_tpu "
              "metrics)", file=sys.stderr)
        return 2
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FuzzConfig, SimConfig, simulate
    proto = sim_protocol(args.algorithm)
    cfg = SimConfig(n_replicas=args.replicas)
    fuzz = FuzzConfig(p_drop=args.p_drop, p_dup=args.p_dup,
                      max_delay=args.max_delay)
    res = simulate(proto, cfg, args.groups, args.steps, fuzz=fuzz,
                   seed=args.seed, series=True, device=args.device)
    series = {k: [int(x) for x in v]
              for k, v in sorted(res.counter_series.items())}
    lat = res.latency_summary()
    if args.csv:
        # one row a step, one column a counter; run-level context (the
        # commit-latency summary) as '#' header comments
        lines = [f"# algorithm={args.algorithm} groups={args.groups}"
                 f" steps={args.steps}"
                 f" violations={int(res.violations)}"]
        if lat is not None:
            lines.append(
                f"# commit_latency n={lat['n']}"
                f" p50_rounds={lat['p50_rounds']}"
                f" p99_rounds={lat['p99_rounds']}"
                f" p999_rounds={lat['p999_rounds']}"
                f" inscan_violations={res.inscan_violations}")
        names = list(series)
        lines.append(",".join(["step"] + names))
        for t in range(args.steps):
            lines.append(",".join(
                [str(t)] + [str(series[n][t]) for n in names]))
        text = "\n".join(lines) + "\n"
    else:
        doc = {
            "algorithm": args.algorithm,
            "groups": args.groups,
            "steps": args.steps,
            "violations": int(res.violations),
            "series": series,
        }
        if lat is not None:
            doc["commit_latency"] = lat
            doc["inscan_violations"] = res.inscan_violations
        text = json.dumps(doc) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


def _git_changed_py(root) -> list:
    """Files for ``lint --changed``: tracked modifications vs HEAD plus
    untracked files, filtered to ``paxi_tpu_torch/*.py`` (the analyzer's
    universe).  Deleted files vanish from the diff listing only once
    unlinked, so drop anything that no longer exists."""
    import subprocess
    from pathlib import Path

    names: list = []
    for cmd in (["git", "diff", "--name-only", "HEAD", "--"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            out = subprocess.run(cmd, cwd=root, capture_output=True,
                                 text=True, check=True).stdout
        except (OSError, subprocess.CalledProcessError) as e:
            raise ValueError(f"--changed needs a git checkout: {e}")
        names.extend(out.splitlines())
    seen = set()
    changed = []
    for n in names:
        if (n.endswith(".py") and n.startswith("paxi_tpu_torch/")
                and n not in seen and (root / n).is_file()):
            seen.add(n)
            changed.append(Path(root / n))
    return changed


def cmd_lint(args) -> int:
    """paxi-lint over the port (``paxi_tpu_torch/analysis``).

    Exits 0 when the tree is clean modulo the checked-in baseline
    (``analysis/baseline.toml``), 1 on violations, 2 on a usage error —
    the JAX package's ``lint`` contract, with its JSON field names."""
    from pathlib import Path

    from paxi_tpu_torch import analysis

    if args.graph:
        # the cross-module call graph the PXF and PXK rules walk, as DOT
        from paxi_tpu_torch.analysis.project import shared_index
        print(shared_index(analysis.repo_root()).to_dot())
        return 0

    paths = [Path(p) for p in args.paths]
    strict_targets = False
    if args.changed:
        if paths:
            print("lint: --changed and explicit paths are exclusive",
                  file=sys.stderr)
            return 2
        changed = _git_changed_py(analysis.repo_root())
        if not changed:
            print("lint: no changed paxi_tpu_torch/*.py files — nothing "
                  "to do")
            return 0
        paths = changed
        # a changed file outside a family's TARGETS globs must stay
        # outside it (same verdicts as a full run, just scoped)
        strict_targets = True
    baseline = None if args.no_baseline else (
        Path(args.baseline) if args.baseline else analysis.DEFAULT_BASELINE)
    try:
        report = analysis.run_lint(
            rules=args.rule or None,
            baseline_path=baseline,
            paths=paths or None,
            strict_targets=strict_targets)
    except (KeyError, ValueError) as e:
        print(f"lint: {e}", file=sys.stderr)
        return 2
    if args.sarif:
        text = report.to_sarif()
        if args.sarif == "-":
            print(text)
        else:
            Path(args.sarif).write_text(text + "\n")
    if args.json:
        print(report.to_json())
    else:
        print(report.render(verbose=args.verbose))
    if args.strict_unused and report.unused_baseline:
        print("lint: stale baseline entries (see warnings above) — "
              "baselines may only shrink; delete them", file=sys.stderr)
        return 1
    return 0 if report.ok else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="paxi_tpu_torch",
        description="the paxi_tpu sim runtime on PyTorch and CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("sim", help="sim runtime (batched fuzzing)")
    m.add_argument("-algorithm", "--algorithm", default="paxos")
    m.add_argument("-groups", type=int, default=1024)
    m.add_argument("-steps", type=int, default=100)
    m.add_argument("-replicas", type=int, default=3)
    m.add_argument("-slots", type=int, default=128)
    m.add_argument("-keys", type=int, default=16)
    m.add_argument("-zones", type=int, default=1)
    m.add_argument("-seed", type=int, default=0)
    m.add_argument("-p_drop", type=float, default=0.0)
    m.add_argument("-p_dup", type=float, default=0.0)
    m.add_argument("-p_crash", type=float, default=0.0)
    m.add_argument("-p_partition", type=float, default=0.0)
    m.add_argument("-max_delay", type=int, default=1)
    m.add_argument("-shard", action="store_true",
                   help="shard groups over the ranks torchrun starts")
    m.add_argument("-profile", "--profile", default="",
                   help="write a torch.profiler Chrome trace to this dir")
    _device_arg(m)
    m.set_defaults(fn=cmd_sim)

    pr = sub.add_parser("profile",
                        help="per-phase wall timings (build/warmup/run) "
                             "+ optional torch.profiler trace")
    pr.add_argument("-algorithm", "--algorithm", default="paxos_pg")
    pr.add_argument("-groups", type=int, default=2048)
    pr.add_argument("-steps", type=int, default=36)
    pr.add_argument("-replicas", type=int, default=5)
    pr.add_argument("-slots", type=int, default=64)
    pr.add_argument("-seed", type=int, default=0)
    pr.add_argument("-shard", type=int, default=0, metavar="N",
                    help="profile sharded over N local ranks (0 = one)")
    pr.add_argument("-repeats", type=int, default=3,
                    help="timed runs; best wall reported")
    pr.add_argument("-p_drop", type=float, default=0.0)
    pr.add_argument("-p_dup", type=float, default=0.0)
    pr.add_argument("-max_delay", type=int, default=1)
    pr.add_argument("-trace_dir", "-trace-dir", "--trace-dir",
                    dest="trace_dir", default="",
                    help="also write a torch.profiler Chrome trace here")
    _device_arg(pr)
    pr.set_defaults(fn=cmd_profile)

    t = sub.add_parser("trace", help="violation traces: replay/shrink")
    tsub = t.add_subparsers(dest="trace_cmd", required=True)
    ti = tsub.add_parser("info", help="print a trace's provenance")
    ti.add_argument("file")
    tre = tsub.add_parser("replay",
                          help="pinned deterministic replay in the sim")
    tre.add_argument("file")
    tre.add_argument("-twice", "--twice", action="store_true",
                     help="replay twice and assert identical outcomes")
    tsh = tsub.add_parser("shrink", help="delta-debug a minimal witness")
    tsh.add_argument("file")
    tsh.add_argument("-o", "--out", default="")
    tsh.add_argument("-max_trials", "--max-trials", dest="max_trials",
                     type=int, default=200)
    for sp in (ti, tre, tsh):
        _device_arg(sp)
    tho = tsub.add_parser("host",
                          help="project onto host fault directives")
    tho.add_argument("file")
    tho.add_argument("-step_ms", "--step-ms", dest="step_ms",
                     type=float, default=50.0)
    tho.add_argument("-seq", "--seq", action="store_true",
                     help="also emit the sequenced (virtual-clock) "
                          "delivery schedule")
    tho.add_argument("-all", "--all", action="store_true",
                     help="batch mode: projection coverage under every "
                          "protocol's TRACE_MSG_MAP")
    t.set_defaults(fn=cmd_trace)

    h = sub.add_parser("hunt",
                       help="divergence-hunting campaigns (sim->host)")
    hsub = h.add_subparsers(dest="hunt_cmd", required=True)
    for name, desc in (("run", "run/resume a campaign"),
                       ("status", "print campaign progress"),
                       ("report", "regenerate HUNT_REPORT.json/.md")):
        hp = hsub.add_parser(name, help=desc)
        hp.add_argument("-dir", "--dir", default="",
                        help="campaign directory (state + corpus + "
                             "reports; default build/hunt)")
        hp.add_argument("-budget", "--budget", type=int, default=5,
                        help="fuzz runs per protocol")
        hp.add_argument("-protocols", "--protocols", default="",
                        help="comma-separated subset (default: every "
                             "case protocol)")
        hp.add_argument("-quick", "--quick", action="store_true",
                        help="cap groups/steps for smoke budgets")
        hp.add_argument("-shrink_trials", "--shrink-trials",
                        dest="shrink_trials", type=int, default=120)
        hp.add_argument("-no_host", "--no-host", dest="no_host",
                        action="store_true",
                        help="skip host replay (coverage-only verdicts)")
        hp.add_argument("-traces_dir", "--traces-dir",
                        dest="traces_dir", default="",
                        help="seed corpus from this trace dir on first "
                             "run (default: build/traces)")
        hp.add_argument("-quiet", "--quiet", action="store_true")
        _device_arg(hp)
    h.set_defaults(fn=cmd_hunt)

    sc = sub.add_parser("scenario",
                        help="WAN topology / churn / reconfig scenarios")
    scsub = sc.add_subparsers(dest="scenario_cmd", required=True)
    scl = scsub.add_parser("list", help="print the named-scenario catalog")
    scr = scsub.add_parser("run", help="run one named scenario on the sim "
                           "or the host fabric")
    scr.add_argument("-scenario", "--scenario", default="wan3z",
                     help="a name from `scenario list`")
    scr.add_argument("-algorithm", "--algorithm", default="wpaxos")
    scr.add_argument("-host", "--host", action="store_true",
                     help="run on the host runtime over the "
                          "virtual-clock fabric instead of the sim")
    scr.add_argument("-groups", type=int, default=16)
    scr.add_argument("-steps", type=int, default=120)
    scr.add_argument("-replicas", type=int, default=9)
    scr.add_argument("-zones", type=int, default=3)
    scr.add_argument("-slots", type=int, default=16)
    scr.add_argument("-keys", type=int, default=16)
    scr.add_argument("-objects", type=int, default=6)
    scr.add_argument("-locality", type=float, default=0.8)
    scr.add_argument("-seed", type=int, default=0)
    scr.add_argument("-p_drop", type=float, default=0.0)
    scr.add_argument("-max_delay", type=int, default=1)
    for sp in (scl, scr):
        _device_arg(sp)
    sc.set_defaults(fn=cmd_scenario)

    wp = sub.add_parser("workload",
                        help="workload engine: key skew, read mixes, "
                             "flash crowds")
    wpsub = wp.add_subparsers(dest="workload_cmd", required=True)
    wpl = wpsub.add_parser("list", help="print the named-spec catalog")
    wpl.add_argument("-keys", type=int, default=64,
                     help="key-space size the descriptions assume")
    wpr = wpsub.add_parser("run", help="run one named spec on the sim")
    wpr.add_argument("-workload", "--workload", default="zipf99",
                     help="a name from `workload list`")
    wpr.add_argument("-algorithm", "--algorithm", default="paxos")
    wpr.add_argument("-groups", type=int, default=16)
    wpr.add_argument("-steps", type=int, default=120)
    wpr.add_argument("-replicas", type=int, default=3)
    wpr.add_argument("-zones", type=int, default=1)
    wpr.add_argument("-slots", type=int, default=16)
    wpr.add_argument("-keys", type=int, default=64)
    wpr.add_argument("-objects", type=int, default=8)
    wpr.add_argument("-seed", type=int, default=0)
    wpr.add_argument("-p_drop", type=float, default=0.0)
    wpr.add_argument("-max_delay", type=int, default=1)
    for sp in (wpl, wpr):
        _device_arg(sp)
    wp.set_defaults(fn=cmd_workload)

    me = sub.add_parser("metrics",
                        help="the sim's per-step counter series (--series)")
    me.add_argument("-series", "--series", action="store_true",
                    help="run the sim and export the per-step counter "
                         "time series")
    me.add_argument("-csv", "--csv", action="store_true",
                    help="with -series: CSV, one row a step")
    me.add_argument("-out", "--out", default="",
                    help="write the export to this file, not stdout")
    me.add_argument("-algorithm", "--algorithm", default="paxos")
    me.add_argument("-groups", type=int, default=64)
    me.add_argument("-steps", type=int, default=100)
    me.add_argument("-replicas", type=int, default=3)
    me.add_argument("-seed", type=int, default=0)
    me.add_argument("-p_drop", type=float, default=0.0)
    me.add_argument("-p_dup", type=float, default=0.0)
    me.add_argument("-max_delay", type=int, default=1)
    _device_arg(me)
    me.set_defaults(fn=cmd_metrics)

    li = sub.add_parser(
        "lint", help="protocol-aware static analysis of the port's kernels "
                     "(paxi-lint; no card needed)")
    li.add_argument("paths", nargs="*", default=[],
                    help="restrict to these files/directories "
                         "(default: the whole port)")
    li.add_argument("-rule", "--rule", action="append", default=[],
                    help="run only these rule families: names "
                         "(`kernel-purity`) or code prefixes "
                         "(`PXK,PXF`); repeatable")
    li.add_argument("-json", "--json", action="store_true",
                    help="machine-readable report")
    li.add_argument("-verbose", "--verbose", action="store_true",
                    help="also list suppressed findings")
    li.add_argument("-baseline", "--baseline", default="",
                    help="alternate baseline file")
    li.add_argument("-no_baseline", "--no-baseline", dest="no_baseline",
                    action="store_true",
                    help="ignore the baseline (show every finding)")
    li.add_argument("-strict_unused", "--strict-unused",
                    dest="strict_unused", action="store_true",
                    help="exit 1 on stale (unused) baseline entries")
    li.add_argument("-sarif", "--sarif", default="",
                    help="also write the report as SARIF 2.1.0 to this "
                         "path (`-` for stdout)")
    li.add_argument("-changed", "--changed", action="store_true",
                    help="lint only paxi_tpu_torch/*.py files changed vs "
                         "git HEAD (plus untracked); families keep their "
                         "TARGETS scoping so verdicts agree with a full "
                         "run")
    li.add_argument("-graph", "--graph", action="store_true",
                    help="dump the ProjectIndex cross-module call graph "
                         "as GraphViz DOT instead of linting")
    li.set_defaults(fn=cmd_lint)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
