"""Command-line entry points of the port (the JAX package's ``cli.py``:
the same subcommands, flags, JSON output and exit codes).

The reference's three binaries, on the host runtime (asyncio Python on
the CPU, the client REST API of ``host/http.py``):

    python -m paxi_tpu_torch server -id 1.1 -algorithm paxos [-simulation]
        (``-simulation`` runs every id of the config in one process over
        the in-process fabric, each serving its HTTP address)
    python -m paxi_tpu_torch client [-N 60 | -T 10]
        (the closed-loop benchmark of the config's benchmark block, with
        the linearizability check)
    python -m paxi_tpu_torch cmd     (the admin REPL: get/put/crash/drop)
    python -m paxi_tpu_torch bench-host [--open-loop] [--cluster-proc]
    python -m paxi_tpu_torch metrics -url URL | -file F [-raw] | --series
    python -m paxi_tpu_torch spans render|export -url URL | -file F

and the sim runtime:

    python -m paxi_tpu_torch sim -algorithm paxos -groups 100000 \
        -replicas 5 -slots 64 -steps 104
    python -m paxi_tpu_torch profile | trace info|replay|shrink|host FILE |
        hunt run|status|report [--no-host] | scenario list|run [-host] |
        workload list|run | lint [PATHS]

Every subcommand that runs the sim takes ``-device``/``--device``: the
card by default, ``cpu`` to run on the CPU.  The host runtime (serving,
``trace host``'s projection, ``scenario run -host`` and the hunt's host
replay) is asyncio Python on the CPU, as in the JAX package; it drives
the host twin of every protocol (``protocols._HOST_MODULES``).
``lint`` is the port's paxi-lint (``paxi_tpu_torch/analysis``): pure AST,
it needs no card.  ``bench-host --shards`` waits for the port of the
JAX package's ``shard/`` and exits 2.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


def _device_arg(sp) -> None:
    sp.add_argument("-device", "--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")


def _ints(metrics, skip=()) -> dict:
    return {k: int(v) for k, v in metrics.items()
            if not any(k.startswith(p) for p in skip)}


# ---- serving (the host runtime's client REST API) ----------------------

def _load_config(args):
    from paxi_tpu_torch.core.config import Config, local_config
    if args.config:
        return Config.from_json(args.config)
    return local_config(args.n, zones=getattr(args, "zones", 1))


def cmd_server(args) -> int:
    """One replica over its configured transport, or (``-simulation``)
    every replica of the config in this process."""
    from paxi_tpu_torch.utils import log
    cfg = _load_config(args)
    log.configure(args.log_level, args.log_dir, tag=args.id or "sim")
    if args.simulation:
        from paxi_tpu_torch.host.simulation import Cluster
        cfg.addrs = {i: f"chan://sim/{i}" for i in cfg.addrs}

        async def main():
            c = Cluster(args.algorithm, cfg=cfg)
            await c.start()
            log.infof("simulation: %d replicas of %s running",
                      len(cfg.addrs), args.algorithm)
            await asyncio.Event().wait()
        asyncio.run(main())
        return 0
    from paxi_tpu_torch.core.ident import ID
    from paxi_tpu_torch.protocols import host_replica
    replica = host_replica(args.algorithm)(ID(args.id), cfg)
    log.infof("server %s (%s) on %s", args.id, args.algorithm,
              cfg.addrs[ID(args.id)])
    replica.run_forever()
    return 0


def cmd_client(args) -> int:
    """The closed-loop benchmark against the config's HTTP addresses."""
    cfg = _load_config(args)
    b = cfg.benchmark
    if args.T is not None:
        b.T, b.N = args.T, 0
    if args.N is not None:
        b.T, b.N = 0, args.N
    if args.concurrency:
        b.concurrency = args.concurrency
    from paxi_tpu_torch.host.benchmark import Benchmark
    bench = Benchmark(cfg, b, seed=args.seed)
    stats = asyncio.run(bench.run())
    print(json.dumps(stats.summary()))
    if args.history_file:
        bench.history.write_file(args.history_file)
    if stats.ops == 0 or (stats.anomalies or 0) > 0:
        return 1   # total failure or a safety anomaly
    return 0


def cmd_bench_host(args) -> int:
    """Host-serving benchmark (one protocol through the full stack).

    Default: the closed-loop generator (``bench_host`` semantics, one
    protocol).  ``--open-loop``: Poisson arrivals over pipelined
    connections ramped across ``-rates``, reporting the saturation curve
    (offered vs achieved vs latency) and a linearizability verdict over
    the whole run; ``-out`` writes the artifact.  ``--cluster-proc`` runs
    the cluster in a subprocess so the load generator and the replicas
    do not share one interpreter."""
    import os
    import subprocess
    import tempfile

    from paxi_tpu_torch.core.config import local_config
    from paxi_tpu_torch.host.transport import wait_listening

    if args.shards:
        print("bench-host: --shards needs the sharded serving tier (the "
              "JAX package's shard/, ROADMAP item 29), which the port "
              "has not ported yet", file=sys.stderr)
        return 2

    cfg = _load_config(args)
    if not args.config:
        cfg = local_config(args.n, zones=args.zones,
                           base_port=args.base_port)
    cfg.batch_size = args.batch_size
    cfg.batch_wait = args.batch_wait
    cfg.leader_reads = args.leader_reads
    rates = [float(r) for r in args.rates.split(",") if r]

    if args.trace_sample > 0:
        # head-based sampling at the node HTTP entry; subprocess
        # clusters inherit the rate via PAXI_TRACE_SAMPLE below
        from paxi_tpu_torch.obs import set_sample_rate
        set_sample_rate(args.trace_sample)

    wl = None
    if args.workload:
        from paxi_tpu_torch.workload import named_workload
        try:
            wl = named_workload(args.workload)
        except KeyError as e:
            print(f"bench-host: {e.args[0]}", file=sys.stderr)
            return 2

    async def run_open_loop(target_cfg, worker_rates=None):
        from paxi_tpu_torch.host.benchmark import OpenLoopBenchmark
        bench = OpenLoopBenchmark(
            target_cfg, rates=worker_rates or rates, step_s=args.step_s,
            seed=args.seed, conns=args.conns, W=args.W, K=args.K,
            key_base=args.key_base, client_tag=args.client_tag,
            ops_per_req=args.ops_per_req,
            max_inflight=args.max_inflight,
            linearizability_check=not args.no_lin,
            workload=wl, wl_stream=args.wl_stream)
        return await bench.run()

    if args.attach:
        # generator-worker mode: drive an already-running cluster over
        # the config's http addrs and print the raw report (the parent
        # merges workers' counts, histograms and verdicts)
        out = asyncio.run(run_open_loop(cfg))
        print(json.dumps(out))
        return 0 if (out.get("anomalies") or 0) == 0 \
            and out["total_completed"] > 0 else 1

    async def scrape_metrics(target_cfg):
        """The leader's metrics snapshot over the REST surface (GET
        /metrics?format=json), without reaching into another process."""
        from paxi_tpu_torch.host.client import _Conn
        conn = _Conn(target_cfg.http_addrs[target_cfg.ids[0]])
        try:
            status, _, payload = await conn.request(
                "GET", "/metrics?format=json", {}, b"")
            return json.loads(payload.decode()) if status == 200 else {}
        except (IOError, OSError):
            return {}
        finally:
            conn.close()

    async def scrape_spans(target_cfg):
        """Every node's GET /spans, merged and reduced to the five-phase
        decomposition (queue/batch/quorum/exec/writeback)."""
        from paxi_tpu_torch.host.client import Client
        from paxi_tpu_torch.obs import aggregate_phases
        cl = Client(target_cfg)
        try:
            return aggregate_phases(await cl.spans_all())
        finally:
            cl.close()

    def wait_http(url, timeout_s=20.0):
        return asyncio.run(wait_listening(url, timeout_s=timeout_s))

    report = {"protocol": args.algorithm, "replicas": cfg.n,
              "zones": len(cfg.zones()),
              "batch_size": cfg.batch_size,
              "batch_wait": cfg.batch_wait,
              "leader_reads": cfg.leader_reads,
              "ops_per_req": args.ops_per_req,
              **({"workload": wl.name} if wl is not None else {}),
              "cluster_proc": bool(args.cluster_proc
                                   or args.gen_procs > 1)}

    if args.cluster_proc or args.gen_procs > 1:
        # the cluster lives in its own interpreter: chan peers inside
        # that process, real TCP HTTP towards this one
        cfg.addrs = {i: f"chan://benchhost/{i}" for i in cfg.addrs}
        with tempfile.NamedTemporaryFile(
                "w", suffix=".json", delete=False) as f:
            cfg_path = f.name
        cfg.to_json(cfg_path)
        proc = subprocess.Popen(
            [sys.executable, "-m", "paxi_tpu_torch", "server",
             "-simulation", "-algorithm", args.algorithm,
             "-config", cfg_path],
            env={**os.environ, "PAXI_TRACE_SAMPLE": str(args.trace_sample)})
        try:
            if not wait_http(cfg.http_addrs[cfg.ids[0]]):
                print("bench-host: cluster subprocess never came up",
                      file=sys.stderr)
                return 2
            if args.open_loop and args.gen_procs > 1:
                out = _parallel_workers(args, cfg_path, rates)
                out["cluster_metrics"] = asyncio.run(scrape_metrics(cfg))
            elif args.open_loop:
                out = asyncio.run(run_open_loop(cfg))
                out["cluster_metrics"] = asyncio.run(scrape_metrics(cfg))
            else:
                out = asyncio.run(_closed_loop(args, cfg))
            if args.trace_sample > 0:
                out["span_phases"] = asyncio.run(scrape_spans(cfg))
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
            try:
                os.unlink(cfg_path)
            except OSError:
                pass
        report.update(out)
    else:
        async def inproc():
            from paxi_tpu_torch.host.simulation import Cluster
            cfg.addrs = {i: f"chan://benchhost/{i}" for i in cfg.addrs}
            c = Cluster(args.algorithm, cfg=cfg, http=True)
            await c.start()
            try:
                if args.open_loop:
                    out = await run_open_loop(cfg)
                else:
                    out = await _closed_loop(args, cfg)
                from paxi_tpu_torch.metrics import merge_snapshots
                out["cluster_metrics"] = merge_snapshots(
                    r.metrics.snapshot() for r in c.replicas.values())
                if args.trace_sample > 0:
                    from paxi_tpu_torch.obs import aggregate_phases, merge
                    out["span_phases"] = aggregate_phases(merge(
                        [r.spans.export()
                         for r in c.replicas.values()]))
                return out
            finally:
                await c.stop()
        report.update(asyncio.run(inproc()))

    print(json.dumps({k: v for k, v in report.items()
                      if k != "cluster_metrics"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    anomalies = report.get("anomalies")
    completed = report.get("total_completed", report.get("ops", 0))
    return 1 if (anomalies or 0) > 0 or completed == 0 else 0


def _parallel_workers(args, cfg_path: str, rates) -> dict:
    """Fan the offered load over ``-gen_procs`` generator subprocesses
    (each rate split evenly; disjoint key ranges and client tags) and
    merge their reports: counts add, per-rate latency histograms
    bucket-merge exactly, per-key-slice linearizability verdicts add."""
    import subprocess

    from paxi_tpu_torch.metrics import Histogram

    n = args.gen_procs
    worker_rates = [r / n for r in rates]
    procs = []
    for w in range(n):
        cmd = [sys.executable, "-m", "paxi_tpu_torch", "bench-host",
               "--open-loop", "--attach", "-config", cfg_path,
               "-rates", ",".join(str(r) for r in worker_rates),
               "-step_s", str(args.step_s), "-conns", str(args.conns),
               "-W", str(args.W), "-K", str(args.K),
               "-seed", str(args.seed + 1000 * w),
               "-key_base", str(w * args.K),
               "-ops_per_req", str(args.ops_per_req),
               "-max_inflight", str(args.max_inflight),
               "-client_tag", f"w{w}c"]
        if args.workload:
            # each worker keeps the spec but draws its own counter
            # stream (deterministic per worker, independent across)
            cmd += ["-workload", args.workload, "-wl_stream", str(w)]
        if args.no_lin:
            cmd.append("--no-lin")
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE))
    reports = []
    for w, p in enumerate(procs):
        stdout, _ = p.communicate(timeout=600)
        lines = stdout.decode().splitlines()
        if p.returncode != 0 or not lines:
            for q in procs:          # don't leave siblings running
                if q.poll() is None:
                    q.kill()
            raise RuntimeError(
                f"bench-host generator worker {w} failed "
                f"(rc={p.returncode}, {len(lines)} output lines) — "
                f"its stderr was inherited, see above")
        reports.append(json.loads(lines[-1]))

    steps = []
    for i, rate in enumerate(rates):
        merged = {"offered_ops_s": rate, "duration_s": args.step_s}
        for k in ("submitted", "completed", "errors", "shed",
                  "unfinished"):
            merged[k] = sum(r["steps"][i][k] for r in reports)
        merged["achieved_ops_s"] = round(
            sum(r["steps"][i]["achieved_ops_s"] for r in reports), 1)
        h = Histogram()
        by_class: dict = {}
        for r in reports:
            for hs in r["metrics"]["histograms"]:
                if hs["labels"].get("rate") != str(worker_rates[i]):
                    continue
                kc = hs["labels"].get("key_class")
                if kc is None:
                    h.merge(Histogram.from_snapshot(hs))
                else:
                    # workers double-record into a per-key-class series;
                    # keep it out of the overall merge and bucket-merge
                    # per class instead
                    by_class.setdefault(kc, Histogram()).merge(
                        Histogram.from_snapshot(hs))
        merged["latency_ms"] = {
            "mean": round(h.mean() * 1e3, 3),
            "p50": round(h.percentile(50) * 1e3, 3),
            "p95": round(h.percentile(95) * 1e3, 3),
            "p99": round(h.percentile(99) * 1e3, 3),
            "max": round(h.max * 1e3, 3),
        }
        if by_class:
            merged["key_class_latency"] = {
                c: {"n": ch.count,
                    "p50_ms": round(ch.percentile(50) * 1e3, 3),
                    "p99_ms": round(ch.percentile(99) * 1e3, 3)}
                for c, ch in by_class.items()}
        steps.append(merged)
    achieved = [s["achieved_ops_s"] for s in steps]
    peak = max(range(len(steps)), key=lambda i: achieved[i])
    anomalies = None if args.no_lin else sum(
        r["anomalies"] or 0 for r in reports)
    return {
        "mode": "open-loop",
        "gen_procs": n,
        "conns_per_gen": args.conns,
        "W": args.W, "K": args.K,
        "steps": steps,
        "peak_ops_s": achieved[peak],
        "peak_offered_ops_s": steps[peak]["offered_ops_s"],
        "total_completed": sum(s["completed"] for s in steps),
        "total_errors": sum(s["errors"] for s in steps),
        "total_shed": sum(s["shed"] for s in steps),
        "anomalies": anomalies,
        "history_ops": sum(r["history_ops"] for r in reports),
    }


async def _closed_loop(args, cfg) -> dict:
    from paxi_tpu_torch.core.config import Bconfig
    from paxi_tpu_torch.host.benchmark import Benchmark
    cfg.benchmark = Bconfig(T=args.T, K=args.K, W=args.W,
                            concurrency=args.concurrency,
                            warmup=args.warmup,
                            linearizability_check=not args.no_lin)
    wl = None
    if args.workload:
        from paxi_tpu_torch.workload import named_workload
        wl = named_workload(args.workload)
    bench = Benchmark(cfg, cfg.benchmark, seed=args.seed, workload=wl)
    stats = await bench.run()
    return dict(stats.summary(), mode="closed-loop")


def cmd_repl(args) -> int:
    """Interactive admin REPL (bin/cmd): get/put/crash/drop/slow/flaky."""
    cfg = _load_config(args)
    from paxi_tpu_torch.host.client import AdminClient, Client

    async def main():
        client = Client(cfg, id=args.id or None, client_id="cmd")
        admin = AdminClient(cfg)
        print("commands: get K | put K V | crash ID T | drop ID1 ID2 T | "
              "slow ID1 ID2 MS T | flaky ID1 ID2 P T | exit")
        loop = asyncio.get_running_loop()
        while True:
            try:
                line = await loop.run_in_executor(None, input, "paxi> ")
            except (EOFError, KeyboardInterrupt):
                break
            parts = line.split()
            if not parts:
                continue
            try:
                op = parts[0]
                if op == "exit":
                    break
                elif op == "get":
                    print((await client.get(int(parts[1]))).decode("latin1"))
                elif op == "put":
                    await client.put(int(parts[1]), parts[2].encode())
                    print("ok")
                elif op == "crash":
                    await admin.crash(parts[1], float(parts[2]))
                    print("ok")
                elif op == "drop":
                    await admin.drop(parts[1], parts[2], float(parts[3]))
                    print("ok")
                elif op == "slow":
                    await admin.slow(parts[1], parts[2], float(parts[3]),
                                     float(parts[4]))
                    print("ok")
                elif op == "flaky":
                    await admin.flaky(parts[1], parts[2], float(parts[3]),
                                      float(parts[4]))
                    print("ok")
                else:
                    print(f"unknown command {op!r}")
            except Exception as e:  # REPL: report, keep going
                print(f"error: {e}")
        client.close()
        admin.close()
    asyncio.run(main())
    return 0


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
    """Pretty-print a metrics snapshot from either source: scrape a live
    host node's /metrics endpoint (``-url``), or pull the snapshots
    embedded in a JSON artifact (``-file``: BENCH_HOST.json,
    FUZZ_SOAK.json, ...).  With ``--series``, run the sim instead and
    export the per-step counter time series (JSON, or CSV with
    ``-csv``)."""
    if not args.series:
        return _metrics_snapshots(args)
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


def _find_snapshots(doc, out) -> None:
    """Walk a JSON document for metric payloads: registry snapshots
    ({"counters": [...], "histograms": [...]}) and the sim runtime's
    plain counter dicts ({"counters": {name: int}})."""
    if isinstance(doc, dict):
        c = doc.get("counters")
        if isinstance(c, list) or isinstance(doc.get("histograms"), list):
            out.append({"counters": c if isinstance(c, list) else [],
                        "histograms": doc.get("histograms", [])})
            return
        if isinstance(c, dict):
            out.append({"counters": [
                {"name": f"net_{k}", "labels": {}, "value": int(v)}
                for k, v in c.items()], "histograms": []})
            doc = {k: v for k, v in doc.items() if k != "counters"}
        for v in doc.values():
            _find_snapshots(v, out)
    elif isinstance(doc, list):
        for v in doc:
            _find_snapshots(v, out)


def _metrics_snapshots(args) -> int:
    import urllib.request

    from paxi_tpu_torch.metrics import merge_snapshots, pretty

    if args.url:
        base = args.url.rstrip("/")
        if args.raw:
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                sys.stdout.write(r.read().decode())
            return 0
        with urllib.request.urlopen(base + "/metrics?format=json",
                                    timeout=10) as r:
            snaps = [json.load(r)]
    else:
        if not args.file:
            print("metrics: need -url or -file", file=sys.stderr)
            return 2
        with open(args.file) as f:
            doc = json.load(f)
        snaps = []
        _find_snapshots(doc, snaps)
        if not snaps:
            print(f"metrics: no snapshots found in {args.file}",
                  file=sys.stderr)
            return 1
    print(pretty(merge_snapshots(snaps)))
    return 0


def _find_spans(doc, out) -> None:
    """Collect every span list in a JSON document: a raw ``[{span},
    ...]`` dump, a ``{"spans": [...]}`` scrape, or an artifact embedding
    one."""
    if isinstance(doc, dict):
        s = doc.get("spans")
        if (isinstance(s, list)
                and all(isinstance(d, dict) and "sid" in d for d in s)):
            out.append(s)
            doc = {k: v for k, v in doc.items() if k != "spans"}
        for v in doc.values():
            _find_spans(v, out)
    elif isinstance(doc, list):
        if doc and all(isinstance(d, dict) and "sid" in d
                       and "trace" in d for d in doc):
            out.append(doc)
        else:
            for v in doc:
                _find_spans(v, out)


def cmd_spans(args) -> int:
    """Span timelines: render (ASCII) or export (Chrome trace-event JSON
    for chrome://tracing / Perfetto).  ``-url`` scrapes a node's ``GET
    /spans``; ``-file`` reads a JSON artifact and collects every span
    list inside it."""
    import urllib.request

    from paxi_tpu_torch.obs import (ascii_timeline, chrome_trace, merge,
                                    orphans, stitched_traces,
                                    validate_spans)

    if args.url:
        base = args.url.rstrip("/")
        with urllib.request.urlopen(base + "/spans", timeout=10) as r:
            lists = [json.load(r)["spans"]]
    else:
        if not args.file:
            print("spans: need -url or -file", file=sys.stderr)
            return 2
        with open(args.file) as f:
            doc = json.load(f)
        lists = []
        _find_spans(doc, lists)
        if not lists:
            print(f"spans: no span lists found in {args.file}",
                  file=sys.stderr)
            return 1
    spans = merge(lists)
    errs = validate_spans(spans)
    if errs:
        print("spans: schema violations:\n  " + "\n  ".join(errs[:20]),
              file=sys.stderr)
        return 1
    if args.spans_cmd == "export":
        text = json.dumps(chrome_trace(spans), indent=1)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        else:
            sys.stdout.write(text + "\n")
        return 0
    sys.stdout.write(ascii_timeline(spans, width=args.width))
    print(f"{len(spans)} spans, "
          f"{len(stitched_traces(spans))} stitched traces, "
          f"{len(orphans(spans))} orphans")
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
        description="the paxi_tpu sim and host runtimes on PyTorch and CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("-config", "--config", default="")
        sp.add_argument("-n", type=int, default=3,
                        help="replicas for the default local config")
        sp.add_argument("-zones", "--zones", type=int, default=1)
        # empty default: log.configure falls back to $PAXI_LOG_LEVEL
        sp.add_argument("-log_level", "--log-level", dest="log_level",
                        default="")
        sp.add_argument("-log_dir", "--log-dir", dest="log_dir", default="")

    s = sub.add_parser("server", help="run one replica (or -simulation)")
    common(s)
    s.add_argument("-id", "--id", default="1.1")
    s.add_argument("-algorithm", "--algorithm", default="paxos")
    s.add_argument("-simulation", "--simulation", action="store_true")
    s.set_defaults(fn=cmd_server)

    c = sub.add_parser("client", help="closed-loop benchmark client")
    common(c)
    c.add_argument("-id", "--id", default="")
    c.add_argument("-T", type=int, default=None)
    c.add_argument("-N", type=int, default=None)
    c.add_argument("-concurrency", type=int, default=0)
    c.add_argument("-seed", type=int, default=0)
    c.add_argument("-history_file", "--history-file", default="")
    c.set_defaults(fn=cmd_client)

    bh = sub.add_parser(
        "bench-host",
        help="host-serving benchmark: closed-loop or --open-loop "
             "saturation ramp")
    common(bh)
    bh.add_argument("-algorithm", "--algorithm", default="paxos")
    bh.add_argument("-open_loop", "--open-loop", dest="open_loop",
                    action="store_true",
                    help="Poisson arrivals over pipelined connections, "
                         "ramped across -rates")
    bh.add_argument("-cluster_proc", "--cluster-proc",
                    dest="cluster_proc", action="store_true",
                    help="run the cluster in a subprocess (load "
                         "generator and replicas stop sharing a GIL)")
    bh.add_argument("-rates", "--rates",
                    default="1000,2000,5000,10000,20000,40000,60000",
                    help="comma-separated offered-load ramp (ops/s)")
    bh.add_argument("-step_s", "--step-s", dest="step_s", type=float,
                    default=3.0, help="seconds per rate step")
    bh.add_argument("-conns", "--conns", type=int, default=4,
                    help="pipelined connections (open loop)")
    bh.add_argument("-max_inflight", "--max-inflight",
                    dest="max_inflight", type=int, default=4096,
                    help="open-loop in-flight command cap (beyond it "
                         "arrivals shed, counted)")
    bh.add_argument("-ops_per_req", "--ops-per-req", dest="ops_per_req",
                    type=int, default=1,
                    help="client-side command batching: KV commands "
                         "per HTTP request over the Transaction "
                         "surface (1 = plain per-op REST)")
    bh.add_argument("-T", type=int, default=4,
                    help="closed-loop run seconds")
    bh.add_argument("-concurrency", type=int, default=4)
    bh.add_argument("-warmup", "--warmup", type=float, default=1.0,
                    help="closed-loop warmup window (excluded from "
                         "steady-state ops/s)")
    bh.add_argument("-W", type=float, default=0.5,
                    help="write fraction")
    bh.add_argument("-K", type=int, default=1024,
                    help="key-space size")
    bh.add_argument("-seed", type=int, default=0)
    bh.add_argument("-no_lin", "--no-lin", dest="no_lin",
                    action="store_true",
                    help="skip the linearizability history/check")
    bh.add_argument("-batch_size", "--batch-size", dest="batch_size",
                    type=int, default=64,
                    help="commit-path batch ceiling (cfg.batch_size)")
    bh.add_argument("-batch_wait", "--batch-wait", dest="batch_wait",
                    type=float, default=0.0,
                    help="batch flush-timer ceiling in seconds "
                         "(0 = next event-loop tick)")
    bh.add_argument("-leader_reads", "--leader-reads",
                    dest="leader_reads", action="store_true",
                    help="serve reads at the leader's execute barrier "
                         "instead of log slots (read-index mode; the "
                         "linearizability checker still gates the run)")
    bh.add_argument("-base_port", "--base-port", dest="base_port",
                    type=int, default=1735)
    bh.add_argument("-out", "--out", default="",
                    help="write the full artifact (with cluster "
                         "metrics) to this JSON file")
    bh.add_argument("-gen_procs", "--gen-procs", dest="gen_procs",
                    type=int, default=1,
                    help="parallel generator subprocesses (load and "
                         "key space split evenly; implies "
                         "--cluster-proc)")
    bh.add_argument("-attach", "--attach", action="store_true",
                    help="generator-worker mode: drive an already-"
                         "running cluster (used by -gen-procs)")
    bh.add_argument("-key_base", "--key-base", dest="key_base",
                    type=int, default=0, help="key-range offset")
    bh.add_argument("-client_tag", "--client-tag", dest="client_tag",
                    default="ol", help="client-id prefix")
    bh.add_argument("-workload", "--workload", default="",
                    help="drive the load with a named workload spec "
                         "(zipf99, flash, hotrange, ...) instead of "
                         "uniform keys")
    bh.add_argument("-wl_stream", "--wl-stream", dest="wl_stream",
                    type=int, default=0,
                    help="workload sampler stream id (parallel workers "
                         "get distinct streams automatically)")
    bh.add_argument("-shards", "--shards", type=int, default=0,
                    help="sharded mode (the JAX package's shard/): not "
                         "ported yet, exits 2")
    bh.add_argument("-trace_sample", "--trace-sample",
                    dest="trace_sample", type=float, default=0.0,
                    help="span sampling rate 0..1 (0 = tracing off); "
                         "adds the five-phase latency decomposition "
                         "(span_phases) to the artifact")
    bh.set_defaults(fn=cmd_bench_host)

    r = sub.add_parser("cmd", help="admin REPL")
    common(r)
    r.add_argument("-id", "--id", default="")
    r.set_defaults(fn=cmd_repl)

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
                        help="pretty-print metrics (live node or "
                             "artifact), or the sim's per-step counter "
                             "series (--series)")
    me.add_argument("-url", "--url", default="",
                    help="a node's HTTP base, e.g. http://127.0.0.1:2735")
    me.add_argument("-file", "--file", default="",
                    help="a JSON artifact with embedded snapshots")
    me.add_argument("-raw", "--raw", action="store_true",
                    help="with -url: dump the Prometheus text unparsed")
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

    sp = sub.add_parser("spans",
                        help="span timelines: ASCII render or Chrome "
                             "trace-event export")
    spsub = sp.add_subparsers(dest="spans_cmd", required=True)
    for name, desc in (("render", "ASCII timeline per trace"),
                       ("export", "Chrome trace-event JSON "
                                  "(chrome://tracing / Perfetto)")):
        ssp = spsub.add_parser(name, help=desc)
        ssp.add_argument("-url", "--url", default="",
                         help="a node's HTTP base (scrapes GET /spans)")
        ssp.add_argument("-file", "--file", default="",
                         help="a JSON artifact with embedded span "
                              "lists (scrape dump, bench artifact)")
        ssp.add_argument("-out", "--out", default="",
                         help="write output here instead of stdout")
        ssp.add_argument("-width", "--width", type=int, default=48,
                         help="render: bar width in characters")
    sp.set_defaults(fn=cmd_spans)

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
