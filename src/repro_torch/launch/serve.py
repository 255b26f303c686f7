"""Serving launcher of the PyTorch port: prefill + decode over the Loom
execution plans, on the card unless asked otherwise.

PyTorch-port counterpart of ``repro/launch/serve.py``::

    python -m repro_torch.launch.serve --arch qwen3-1.7b --mode serve_packed
    python -m repro_torch.launch.serve --arch qwen3-1.7b --mode serve_int8
    python -m repro_torch.launch.serve --arch qwen3-1.7b --server 3 --batch 2
    python -m repro_torch.launch.serve --arch paper-cnn --device cpu

Modes: ``dense``, ``serve_int8`` (the bit-parallel LM_8b baseline: int8
weights, one exact int8 product per linear) and ``serve_packed`` (Loom's
bit-serial planes, Pw/16 of the weight bytes). The default is
``serve_packed``, where the reference's is ``serve_int8``: the port's
CLI serves Loom's own route unless asked.

It serves ``configs.get(arch, smoke=True)`` (any architecture of the
registry; the VLM's prefill needs image embeddings, which this CLI, like
the reference's, does not supply) with random weights (seed 0),
either through the session API (``--api session``, the default:
``repro_torch.compile``) or the hand-wired launch layer (``--api plan``:
``build_plan`` + explicit weight packing + :func:`make_serve_fns`); both
give identical generations for the same seed. ``--server N`` sends N
staggered requests through a continuous-batching engine (request j:
prompt seed ``prompt-seed + j``, length ``prompt-len + j``), so row j of
its output equals a solo ``--batch 1`` run of that prompt. CNN archs
classify. ``--out-tokens FILE`` saves the generations/predictions as
``.npy``. ``--device cpu`` runs the kernels' plain versions on the CPU.
In server mode ``--audit-rate`` replays that share of the completed
requests on the ``torch_ref`` oracle (the plain versions, on the
session's device; ``--audit-backend`` accepts that one name, since an
oracle on the serving kernels would audit them against themselves) and ``--integrity-every N``
re-verifies the weight fingerprint every N engine steps; the summary line
counts both.

On a mesh, :func:`jit_serve_steps` hands out the meshed session's steps
(``repro_torch.dist``); this CLI serves one process.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.api import backend as backendlib
from repro_torch.api import plan as planlib
from repro_torch.models import model as M
from repro_torch.runtime.audit import REF_BACKEND


def make_serve_fns(cfg, plan):
    """(prefill_step, decode_step) closed over cfg + an ExecutionPlan: the
    session's own entry points (one implementation, so the two APIs
    cannot drift); the port runs them eagerly (the reference jits them)."""
    from repro_torch.api.session import entry_points
    fns = entry_points(cfg, plan)
    return fns["_prefill"], fns["_decode"]


def jit_serve_steps(cfg, plan, mesh, param_specs, cache_specs):
    """(prefill_step, decode_step) on ``mesh``: the meshed session's own
    steps (``api.session.entry_points`` over a ``ShardCtx``), as the
    reference shares ``_jit_lm`` with its session. Nothing is compiled:
    PyTorch runs them eagerly. The steps take this rank's shards of
    the params and the cache; ``param_specs`` and ``cache_specs`` must be
    the trees they were placed by (``model.param_spec_tree``, converted
    for the plan's mode, and ``model.cache_shard_spec_tree(cfg, shard)``:
    the cache's KV heads over "tp", or its sequence over "sp" where the
    mesh's rules select that), else ValueError. ``mesh=None`` gives the
    unsharded steps."""
    from repro_torch.api.session import entry_points
    if mesh is None:
        return make_serve_fns(cfg, plan)
    from repro_torch.dist.parallel import ShardCtx
    shard = ShardCtx(mesh)
    want = M.param_spec_tree(cfg)
    if plan.mode in ("serve_int8", "serve_packed"):
        want = M.convert_specs_for_serving(M.param_skeleton(cfg), want,
                                           plan.mode)
    if param_specs != want:
        raise ValueError("param_specs are not the model's spec tree for "
                         f"mode {plan.mode!r}")
    if cache_specs != M.cache_shard_spec_tree(cfg, shard):
        raise ValueError("cache_specs must be model.cache_shard_spec_tree"
                         "(cfg, shard): the port places the KV cache by "
                         "heads unless the mesh's rules split it")
    fns = entry_points(cfg, plan, shard)
    for fn in (fns["_prefill"], fns["_decode"]):
        fn.shard = shard          # its Comm counts the collectives
    return fns["_prefill"], fns["_decode"]


def _prompts(cfg, args) -> np.ndarray:
    rng = np.random.default_rng(args.prompt_seed)
    return rng.integers(1, cfg.vocab,
                        size=(args.batch, args.prompt_len)).astype(np.int32)


def _generate_plan(cfg, args, policy):
    """The hand-wired launch-layer cell: build_plan + explicit conversion,
    the A/B cross-check of ``repro_torch.compile``."""
    device = torch.device(args.device)
    params = M.init_params(cfg, None, device)
    if args.mode != "dense":
        params = M.convert_params_for_serving(params, policy, args.mode)
        print(f"[serve] packed weights for mode={args.mode} "
              f"(Pw={args.w_bits}: weight bytes x{args.w_bits}/16 of bf16)")
    plan = planlib.build_plan(cfg, policy, mode=args.mode,
                              backend=args.backend)
    if args.mode != "dense":
        plan.record_weight_groups(planlib.counted_weights(cfg, params))
    prefill_fn, decode_fn = make_serve_fns(cfg, plan)
    tokens = torch.from_numpy(_prompts(cfg, args)).long().to(device)
    b, s = tokens.shape
    with torch.inference_mode():
        cache = M.init_cache(cfg, b, cfg.max_seq, device)
        logits, cache = prefill_fn(params, tokens, cache)
        tok = torch.argmax(logits[:, 0], dim=-1)
        out = [tok]
        for i in range(args.gen_len - 1):
            logits, cache = decode_fn(params, tok, s + i, cache)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()


def _compile(cfg, args, policy):
    import repro_torch
    return repro_torch.compile(cfg, policy, mode=args.mode,
                               backend=args.backend, device=args.device,
                               guarded=args.guarded)


def _generate_session(cfg, args, policy):
    """The same serving cell through ``repro_torch.compile``.

    ``--guarded`` compiles with a GuardedBackend and routes the request
    through a ServingSupervisor -- byte-identical generations on the
    fault-free path."""
    sess = _compile(cfg, args, policy)
    if args.mode != "dense":
        print(f"[serve] packed weights for mode={args.mode} "
              f"(Pw={args.w_bits}: weight bytes x{args.w_bits}/16 of bf16)")
    tokens = _prompts(cfg, args)
    if args.guarded:
        from repro_torch.runtime import ServingSupervisor
        sup = ServingSupervisor(sess)
        gen = sup.generate(tokens, args.gen_len)
        print(f"[serve] supervisor health: {sup.health()}")
        return gen
    return sess.generate(tokens, args.gen_len)


def _server_prompt(cfg, args, j: int) -> np.ndarray:
    """Request ``j``'s prompt: seed prompt_seed + j, length prompt_len + j
    -- exactly the prompt of a solo ``--batch 1 --prompt-seed <seed+j>
    --prompt-len <len+j>`` run."""
    rng = np.random.default_rng(args.prompt_seed + j)
    return rng.integers(1, cfg.vocab,
                        size=(args.prompt_len + j,)).astype(np.int32)


def _serve_server(cfg, args, policy):
    """Continuous-batching server mode: ``--server N`` staggered requests
    through a BatchingEngine (supervised when ``--guarded``); returns the
    per-request streams stacked [N, gen_len].

    SIGINT/SIGTERM flips a stop flag checked at every step boundary; the
    engine then runs ``shutdown(--drain-timeout)`` -- in-flight requests
    finish within the bound, residual streams fail loudly with a typed
    ``EngineClosedError``."""
    import signal

    from repro_torch.runtime.batching import BatchingEngine

    sess = _compile(cfg, args, policy)
    target = sess
    sup = None
    if args.guarded:
        from repro_torch.runtime import ServingSupervisor
        target = sup = ServingSupervisor(sess)
    eng = BatchingEngine(target, max_batch=args.batch,
                         max_queue=args.max_queue,
                         step_timeout_s=args.step_timeout,
                         audit_rate=args.audit_rate,
                         integrity_every=args.integrity_every)
    stop_requested = False

    def _on_signal(signum, frame):
        nonlocal stop_requested
        stop_requested = True
        print(f"[serve] caught {signal.Signals(signum).name}: draining "
              f"(bound {args.drain_timeout}s)", flush=True)

    old_handlers = {s: signal.signal(s, _on_signal)
                    for s in (signal.SIGINT, signal.SIGTERM)}
    deadline = args.deadline_s if args.deadline_s > 0 else None
    handles = []
    try:
        for j in range(args.server):
            handles.append(eng.submit(_server_prompt(cfg, args, j),
                                      args.gen_len, deadline_s=deadline))
            if stop_requested:
                break
            eng.step()   # staggered joins: requests join a running batch
        while not stop_requested and eng.step():
            pass
        summary = eng.shutdown(args.drain_timeout)
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
        if sup is not None:
            sup.close()
    streams = np.stack([h.tokens_so_far() for h in handles
                        if len(h.tokens_so_far()) == args.gen_len]) \
        if handles else np.zeros((0, args.gen_len), np.int32)
    st = eng.stats
    print(f"[serve] server: {args.server} requests done "
          f"state={eng.health()['state']} "
          f"engine={eng.state} drained={summary['drained']} "
          f"occupancy={st.batch_occupancy:.2f} "
          f"tokens/s={st.tokens_per_s:.2f} "
          f"queue_depth={st.queue_depth} "
          f"latency p50={st.p50_request_latency_s:.3f}s "
          f"p95={st.p95_request_latency_s:.3f}s "
          f"queue_wait p50={st.p50_queue_wait_s:.3f}s "
          f"p95={st.p95_queue_wait_s:.3f}s "
          f"streamed={st.n_tokens_streamed} "
          f"rejected={st.n_rejected} shed={st.n_shed} "
          f"expired={st.n_deadline_expired} "
          f"restarts={st.n_engine_restarts} "
          f"audits={st.n_audits} divergences={st.n_divergences} "
          f"integrity_checks={st.n_integrity_checks} "
          f"quarantines={st.n_quarantines} "
          f"audit_lag_p95={st.p95_audit_lag_s:.3f}s")
    return streams


def _cnn_inputs(cfg, args) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.normal(size=(args.batch, cfg.img, cfg.img,
                            cfg.in_ch)).astype(np.float32)


def _classify_plan(cfg, args, policy):
    """The CNN cell on the hand-wired launch-layer plan."""
    from repro_torch.models import cnn

    device = torch.device(args.device)
    params = cnn.init_params(cfg, None, device)
    if args.mode != "dense":
        params = M.convert_tree(params, policy, args.mode)
    plan = planlib.build_plan(cfg, policy, mode=args.mode,
                              backend=args.backend)
    if args.mode != "dense":
        plan.record_weight_groups(planlib.counted_weights(cfg, params))
    x = torch.from_numpy(_cnn_inputs(cfg, args)).to(device)
    with torch.inference_mode():
        logits = cnn.forward(params, cfg, x, plan)
    return torch.argmax(logits, dim=-1).cpu().numpy()


def _classify_session(cfg, args, policy):
    """The same CNN cell through ``repro_torch.compile``."""
    sess = _compile(cfg, args, policy)
    if args.guarded:
        from repro_torch.runtime import ServingSupervisor
        sup = ServingSupervisor(sess)
        logits = sup.classify(_cnn_inputs(cfg, args))
        print(f"[serve] supervisor health: {sup.health()}")
    else:
        logits = sess.classify(_cnn_inputs(cfg, args))
    return torch.argmax(logits, dim=-1).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve a smoke-size model of the PyTorch port.")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--mode", default="serve_packed",
                    choices=["dense", "serve_int8", "serve_packed"])
    ap.add_argument("--api", default="session", choices=["session", "plan"],
                    help="session = repro_torch.compile ServingSession; "
                         "plan = hand-wired build_plan + make_serve_fns")
    ap.add_argument("--backend", default="cuda",
                    choices=list(backendlib.list_backends()))
    ap.add_argument("--device", default="cuda",
                    help="torch device the session runs on (cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--dynamic-a", action="store_true",
                    help="runtime per-group activation-plane trimming "
                         "(serve_packed linears and convs)")
    ap.add_argument("--guarded", action="store_true",
                    help="guarded backend (typed faults + fallback chain) "
                         "+ ServingSupervisor request wrapper; "
                         "bit-identical on the fault-free path")
    ap.add_argument("--group-size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--server", type=int, default=0, metavar="N",
                    help="continuous-batching server mode: N staggered "
                         "requests through a BatchingEngine (--batch = "
                         "slot count; request j: seed prompt-seed+j, "
                         "length prompt-len+j); prints the serving "
                         "metrics summary line")
    ap.add_argument("--max-queue", type=int, default=None, metavar="N",
                    help="bound the server-mode request queue; a full "
                         "queue rejects submits with a typed "
                         "QueueFullError (default: unbounded)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request TTL in server mode: expired-while-"
                         "queued requests are shed before prefill, "
                         "in-flight ones retire at the next step "
                         "boundary (0 = no deadline)")
    ap.add_argument("--step-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="decode-watchdog deadline per engine step; a "
                         "stalled step restarts-and-replays instead of "
                         "freezing the queue (default: no watchdog)")
    ap.add_argument("--audit-rate", type=float, default=0.0,
                    metavar="FRACTION",
                    help="server-mode shadow-audit sampling rate in [0,1]: "
                         "that fraction of completed requests is replayed "
                         "off the hot path on the reference oracle and "
                         "byte-compared; a divergence quarantines the "
                         "backend and writes a replayable repro bundle "
                         "(0 = auditing off)")
    ap.add_argument("--audit-backend", default=REF_BACKEND,
                    choices=[REF_BACKEND],
                    help="reference oracle backend for shadow audits: the "
                         "plain versions, on the session's device (the "
                         "serving kernels cannot be their own oracle)")
    ap.add_argument("--integrity-every", type=int, default=0, metavar="N",
                    help="re-verify the packed weights' CRC32 fingerprint "
                         "every N engine steps; a mismatch fails loudly "
                         "with WeightIntegrityError (0 = off)")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    metavar="SECONDS",
                    help="server-mode shutdown bound: in-flight requests "
                         "get this long to finish before residual "
                         "streams are failed loudly")
    ap.add_argument("--prompt-seed", type=int, default=0,
                    help="seed of the random prompt(s); reproduces one "
                         "server request's prompt in a solo batch-1 run")
    ap.add_argument("--a-bits", type=int, default=8)
    ap.add_argument("--w-bits", type=int, default=8)
    ap.add_argument("--out-tokens", default=None, metavar="FILE",
                    help="save the generations/predictions as .npy")
    args = ap.parse_args(argv)

    import dataclasses

    from repro_torch.core.policy import uniform_policy

    cfg = configs.get(args.arch, smoke=True)
    policy = uniform_policy(args.a_bits, args.w_bits,
                            dynamic_a=args.dynamic_a)
    if args.dynamic_a:
        policy = dataclasses.replace(policy, group_size=args.group_size)
    where = f"{args.backend} on {args.device}" + \
        (", dynamic-a" if args.dynamic_a else "")
    if hasattr(cfg, "convs"):            # CNN classification cell
        if args.server:
            raise SystemExit("--server is an LM decode mode; CNN configs "
                             "classify in one shot (drop --server)")
        cls_fn = _classify_session if args.api == "session" else _classify_plan
        gen = cls_fn(cfg, args, policy)
        print(f"[serve] classified {gen.shape[0]} images via {args.api} "
              f"({where}); predictions: {gen}")
    elif args.server:
        gen = _serve_server(cfg, args, policy)
        print(f"[serve] generated {gen.shape} tokens via batching engine "
              f"({where})")
    else:
        gen_fn = _generate_session if args.api == "session" else _generate_plan
        gen = gen_fn(cfg, args, policy)
        print(f"[serve] generated {gen.shape} tokens via {args.api} "
              f"({where}); first row: {gen[0][:8]}...")
    if args.out_tokens:
        np.save(args.out_tokens, gen)
        print(f"[serve] saved outputs to {args.out_tokens}")
    print("done")
    return gen


if __name__ == "__main__":
    main()
