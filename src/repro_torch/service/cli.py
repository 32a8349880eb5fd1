"""DLaaS CLI (paper: 'The CLI provides easy to use command interface over
the REST API').

  dlaas model deploy  --manifest m.yml
  dlaas model list
  dlaas train start   --model <id> [--learners N --gpus G --steps S
                                    --tenant T --priority P
                                    --distribution software-ps|pjit
                                    --compression none|int8
                                    --ps-shards N
                                    --idempotency-key K]
  dlaas train list
  dlaas train status  --id <tid>
  dlaas train perf    --id <tid>            # roofline: bound, attainable
                                            # vs measured rate
  dlaas train logs    --id <tid> [--follow]  # -f tails the live
                                            # structured NDJSON stream
  dlaas train timeline --id <tid> [--json]  # end-to-end trace: phase
                                            # spans (queue/place/run),
                                            # steps, checkpoints,
                                            # recovery + cluster events
  dlaas train delete  --id <tid>
  dlaas train download --id <tid> --out model.npy
  dlaas metrics                             # whole-platform Prometheus
                                            # text (GET /metrics)
  dlaas serve start   --from-training <tid> | --arch <arch-id>
                      [--capacity N --max-queue N --max-new N
                       --tenant T --priority P]
  dlaas serve list
  dlaas serve status  --id <endpoint-id>
  dlaas serve predict --id <endpoint-id> --tokens "1 2 3"
                      [--max-new N --deadline S]
  dlaas serve stop    --id <endpoint-id>        # drain, then stop
  dlaas queue                               # fair-share queue + tenants
  dlaas alerts [--follow] [--max-s S]       # SLO/anomaly alerts: active,
                                            # history + remediation log;
                                            # -f tails the live NDJSON
                                            # alert stream
  dlaas slo                                 # burn-rate evaluation of
                                            # every tracked SLO
  dlaas recovery                            # last crash-recovery report
  dlaas cluster status                      # node lifecycle + autoscaler
  dlaas cluster add    [--gpus G --cpus C --memory M --spot --name N]
  dlaas cluster drain  --node <name>
  dlaas train rescale  --id <tid>           # rebuild gang at current
                                            # capacity (elastic rescale)
  dlaas tenant list
  dlaas tenant set    --name T [--weight W --gpus G --cpus C --memory M]

Speaks plain HTTP via urllib; point it at a server with --url.

Copied from ``repro/service/cli.py`` unchanged: stdlib only (``urllib``),
it speaks HTTP to either package's server. Run it as
``python -m repro_torch.service.cli --url http://127.0.0.1:8080 ...``.
"""
from __future__ import annotations

import argparse
import json
import sys
import urllib.request


def _req(url: str, method: str = "GET", body=None, token: str = "cli",
         idempotency_key=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Authorization", f"Bearer {token}")
    if idempotency_key:
        req.add_header("Idempotency-Key", idempotency_key)
    if data:
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req) as r:
        payload = r.read()
    try:
        return json.loads(payload)
    except (json.JSONDecodeError, UnicodeDecodeError):
        return payload          # binary payload (model download)


def _render_timeline(tl: dict):
    """Human-readable span tree: offset from trace start, duration,
    name, status — children indented under their parent."""
    spans = tl.get("spans", [])
    t0 = tl.get("start") or (spans[0]["start"] if spans else 0.0)
    print(f"trace {tl.get('trace_id')} job {tl.get('job_id')} "
          f"({len(spans)} spans)")
    depth = {}
    for sp in spans:
        depth[sp["span_id"]] = depth.get(sp.get("parent_id"), -1) + 1
        indent = "  " * depth[sp["span_id"]]
        off = sp["start"] - t0
        dur = sp.get("duration_s")
        dur_s = "  [open]" if dur is None else f"{dur * 1000:8.1f}ms"
        mark = "*" if sp.get("kind") == "event" else "-"
        status = "" if sp.get("status") == "ok" else f"  !{sp['status']}"
        attrs = sp.get("attrs") or {}
        extra = " ".join(f"{k}={v}" for k, v in sorted(attrs.items())
                         if k not in ("job_id",))
        print(f"  +{off:7.3f}s {dur_s} {indent}{mark} {sp['name']}"
              f"{status}" + (f"  ({extra})" if extra else ""))
    events = tl.get("cluster_events", [])
    if events:
        print(f"cluster events overlapping this job ({len(events)}):")
        for ev in events:
            attrs = ev.get("attrs") or {}
            extra = " ".join(f"{k}={v}"
                             for k, v in sorted(attrs.items()))
            print(f"  +{ev['start'] - t0:7.3f}s * {ev['name']}  "
                  f"({extra})")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dlaas")
    ap.add_argument("--url", default="http://127.0.0.1:8080")
    ap.add_argument("--token", default="cli")
    sub = ap.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("model")
    msub = m.add_subparsers(dest="sub", required=True)
    d = msub.add_parser("deploy")
    d.add_argument("--manifest", required=True)
    msub.add_parser("list")

    t = sub.add_parser("train")
    tsub = t.add_subparsers(dest="sub", required=True)
    s = tsub.add_parser("start")
    s.add_argument("--model", required=True)
    s.add_argument("--learners", type=int)
    s.add_argument("--gpus", type=int)
    s.add_argument("--steps", type=int)
    s.add_argument("--tenant")
    s.add_argument("--priority", type=int)
    s.add_argument("--distribution",
                   choices=["software-ps", "pjit"],
                   help="execution backend (default: manifest's "
                        "framework.distribution, else software-ps)")
    s.add_argument("--compression", choices=["none", "int8"],
                   help="software-PS push wire format (default: "
                        "manifest's framework.compression, else none)")
    s.add_argument("--ps-shards", type=int, dest="ps_shards",
                   help="software-PS shard count (default: manifest's "
                        "framework.ps_shards, else 4)")
    s.add_argument("--idempotency-key", dest="idempotency_key",
                   help="replay-safe submission: retrying with the same "
                        "key returns the original training")
    tsub.add_parser("list")
    for name in ("status", "logs", "delete", "download", "rescale",
                 "perf", "timeline"):
        p = tsub.add_parser(name)
        p.add_argument("--id", required=True)
        if name == "download":
            p.add_argument("--out", required=True)
        if name == "logs":
            p.add_argument("--follow", "-f", action="store_true")
            p.add_argument("--max-s", type=float, default=5.0,
                           dest="max_s",
                           help="follow window in seconds (default 5)")
        if name == "timeline":
            p.add_argument("--json", action="store_true",
                           help="raw timeline JSON instead of the "
                                "rendered span tree")

    sv = sub.add_parser("serve")
    svsub = sv.add_subparsers(dest="sub", required=True)
    ss = svsub.add_parser("start")
    ss.add_argument("--from-training", dest="from_training",
                    help="completed training id to serve weights from")
    ss.add_argument("--arch", help="model-zoo arch (fresh init weights)")
    ss.add_argument("--capacity", type=int,
                    help="concurrent decode slots (default 2)")
    ss.add_argument("--max-queue", type=int, dest="max_queue",
                    help="admission queue bound (reject with 429 beyond)")
    ss.add_argument("--max-new", type=int, dest="max_new",
                    help="default generated tokens per request")
    ss.add_argument("--gpus", type=int)
    ss.add_argument("--tenant")
    ss.add_argument("--priority", type=int)
    ss.add_argument("--idempotency-key", dest="idempotency_key",
                    help="replay-safe submission: retrying with the same "
                         "key returns the original endpoint")
    svsub.add_parser("list")
    for name in ("status", "predict", "stop"):
        p = svsub.add_parser(name)
        p.add_argument("--id", required=True)
        if name == "predict":
            p.add_argument("--tokens", required=True,
                           help="space-separated token ids")
            p.add_argument("--max-new", type=int, dest="max_new")
            p.add_argument("--deadline", type=float,
                           help="per-request deadline in seconds")

    sub.add_parser("queue")
    sub.add_parser("metrics")

    al = sub.add_parser("alerts")
    al.add_argument("--follow", "-f", action="store_true",
                    help="tail the live alert/remediation stream")
    al.add_argument("--max-s", type=float, default=5.0, dest="max_s",
                    help="follow window in seconds (default 5)")
    sub.add_parser("slo")

    cl = sub.add_parser("cluster")
    clsub = cl.add_subparsers(dest="sub", required=True)
    clsub.add_parser("status")
    ca = clsub.add_parser("add")
    ca.add_argument("--gpus", type=int)
    ca.add_argument("--cpus", type=float)
    ca.add_argument("--memory", type=int)
    ca.add_argument("--spot", action="store_true",
                    help="preemptible node: discounted fair-share cost")
    ca.add_argument("--name")
    cd = clsub.add_parser("drain")
    cd.add_argument("--node", required=True)

    sub.add_parser("recovery")

    tn = sub.add_parser("tenant")
    tnsub = tn.add_subparsers(dest="sub", required=True)
    tnsub.add_parser("list")
    ts = tnsub.add_parser("set")
    ts.add_argument("--name", required=True)
    ts.add_argument("--weight", type=float)      # None = leave unchanged
    ts.add_argument("--gpus", type=int)
    ts.add_argument("--cpus", type=float)
    ts.add_argument("--memory", type=int)

    args = ap.parse_args(argv)
    base = args.url.rstrip("/")

    if args.cmd == "model" and args.sub == "deploy":
        manifest = open(args.manifest).read()
        out = _req(f"{base}/v1/models", "POST",
                   {"manifest": manifest}, args.token)
        print(json.dumps(out))
    elif args.cmd == "model" and args.sub == "list":
        print(json.dumps(_req(f"{base}/v1/models", token=args.token),
                         indent=1))
    elif args.cmd == "train" and args.sub == "start":
        overrides = {k: getattr(args, k) for k in
                     ("learners", "gpus", "steps", "distribution",
                      "compression", "ps_shards")
                     if getattr(args, k) is not None}
        body = {"model_id": args.model, "overrides": overrides}
        if args.tenant is not None:
            body["tenant"] = args.tenant
        if args.priority is not None:
            body["priority"] = args.priority
        out = _req(f"{base}/v1/trainings", "POST", body, args.token,
                   idempotency_key=args.idempotency_key)
        print(json.dumps(out))
    elif args.cmd == "train" and args.sub == "list":
        print(json.dumps(_req(f"{base}/v1/trainings", token=args.token),
                         indent=1))
    elif args.cmd == "train" and args.sub == "status":
        print(json.dumps(_req(f"{base}/v1/trainings/{args.id}",
                              token=args.token), indent=1))
    elif args.cmd == "train" and args.sub == "logs":
        if args.follow:
            # tail the structured live stream: NDJSON records off the
            # job's log-hub tap, rendered one line per record
            req = urllib.request.Request(
                f"{base}/v1/trainings/{args.id}/logs"
                f"?follow=1&max_s={args.max_s}")
            with urllib.request.urlopen(req) as r:
                for raw in r:
                    raw = raw.strip()
                    if not raw:
                        continue
                    try:
                        rec = json.loads(raw)
                    except json.JSONDecodeError:
                        sys.stdout.write(raw.decode() + "\n")
                        continue
                    sys.stdout.write(
                        f"[{rec.get('level', '-')}] "
                        f"{rec.get('member', '-')}: "
                        f"{rec.get('line', '')}\n")
                    sys.stdout.flush()
        else:
            out = _req(f"{base}/v1/trainings/{args.id}/logs",
                       token=args.token)
            print("\n".join(out.get("logs", [])))
    elif args.cmd == "train" and args.sub == "timeline":
        tl = _req(f"{base}/v1/trainings/{args.id}/timeline",
                  token=args.token)
        if args.json:
            print(json.dumps(tl, indent=1))
        else:
            _render_timeline(tl)
    elif args.cmd == "train" and args.sub == "perf":
        print(json.dumps(_req(f"{base}/v1/trainings/{args.id}/perf",
                              token=args.token), indent=1))
    elif args.cmd == "train" and args.sub == "rescale":
        print(json.dumps(_req(f"{base}/v1/trainings/{args.id}/rescale",
                              "POST", {}, args.token)))
    elif args.cmd == "train" and args.sub == "delete":
        print(json.dumps(_req(f"{base}/v1/trainings/{args.id}", "DELETE",
                              token=args.token)))
    elif args.cmd == "train" and args.sub == "download":
        data = _req(f"{base}/v1/trainings/{args.id}/model",
                    token=args.token)
        with open(args.out, "wb") as f:
            f.write(data if isinstance(data, bytes)
                    else json.dumps(data).encode())
        print(f"wrote {args.out}")
    elif args.cmd == "serve" and args.sub == "start":
        body = {k: getattr(args, k) for k in
                ("from_training", "arch", "capacity", "max_queue",
                 "max_new", "gpus", "tenant", "priority")
                if getattr(args, k) is not None}
        print(json.dumps(_req(f"{base}/v1/models", "POST", body,
                              args.token,
                              idempotency_key=args.idempotency_key)))
    elif args.cmd == "serve" and args.sub == "list":
        rows = _req(f"{base}/v1/models", token=args.token)
        print(json.dumps([r for r in rows
                          if r.get("kind") == "endpoint"], indent=1))
    elif args.cmd == "serve" and args.sub == "status":
        print(json.dumps(_req(f"{base}/v1/models/{args.id}",
                              token=args.token), indent=1))
    elif args.cmd == "serve" and args.sub == "predict":
        body = {"tokens": [int(t) for t in args.tokens.split()]}
        if args.max_new is not None:
            body["max_new"] = args.max_new
        if args.deadline is not None:
            body["deadline_s"] = args.deadline
        print(json.dumps(_req(f"{base}/v1/models/{args.id}/predict",
                              "POST", body, args.token)))
    elif args.cmd == "serve" and args.sub == "stop":
        print(json.dumps(_req(f"{base}/v1/models/{args.id}", "DELETE",
                              token=args.token)))
    elif args.cmd == "queue":
        print(json.dumps(_req(f"{base}/v1/queue", token=args.token),
                         indent=1))
    elif args.cmd == "metrics":
        req = urllib.request.Request(f"{base}/metrics")
        req.add_header("Authorization", f"Bearer {args.token}")
        with urllib.request.urlopen(req) as r:
            sys.stdout.write(r.read().decode())
    elif args.cmd == "alerts":
        if args.follow:
            # tail the live alert/remediation NDJSON stream: one
            # snapshot line, then records as the health controller
            # fires/resolves alerts and acts on them
            req = urllib.request.Request(
                f"{base}/v1/alerts?follow=1&max_s={args.max_s}")
            req.add_header("Authorization", f"Bearer {args.token}")
            with urllib.request.urlopen(req) as r:
                for raw in r:
                    raw = raw.strip()
                    if not raw:
                        continue
                    try:
                        rec = json.loads(raw)
                    except json.JSONDecodeError:
                        sys.stdout.write(raw.decode() + "\n")
                        continue
                    if rec.get("type") == "snapshot":
                        sys.stdout.write(
                            f"[snapshot] {len(rec.get('active', []))} "
                            f"active, "
                            f"{len(rec.get('remediations', []))} "
                            f"remediations\n")
                    elif rec.get("type") == "remediation":
                        sys.stdout.write(
                            f"[remediation] {rec.get('action')} "
                            f"for {rec.get('alert')} "
                            f"scope={rec.get('scope')}\n")
                    else:
                        sys.stdout.write(
                            f"[{rec.get('state', '-')}] "
                            f"{rec.get('name')} "
                            f"scope={rec.get('scope')} "
                            f"severity={rec.get('severity')}\n")
                    sys.stdout.flush()
        else:
            print(json.dumps(_req(f"{base}/v1/alerts",
                                  token=args.token), indent=1))
    elif args.cmd == "slo":
        print(json.dumps(_req(f"{base}/v1/slo", token=args.token),
                         indent=1))
    elif args.cmd == "recovery":
        print(json.dumps(_req(f"{base}/v1/recovery", token=args.token),
                         indent=1))
    elif args.cmd == "cluster" and args.sub == "status":
        print(json.dumps(_req(f"{base}/v1/cluster", token=args.token),
                         indent=1))
    elif args.cmd == "cluster" and args.sub == "add":
        body = {k: getattr(args, k) for k in ("gpus", "cpus", "name")
                if getattr(args, k) is not None}
        if args.memory is not None:
            body["memory_mb"] = args.memory
        if args.spot:
            body["spot"] = True
        print(json.dumps(_req(f"{base}/v1/cluster/nodes", "POST", body,
                              args.token)))
    elif args.cmd == "cluster" and args.sub == "drain":
        print(json.dumps(_req(f"{base}/v1/cluster/drain", "POST",
                              {"node": args.node}, args.token)))
    elif args.cmd == "tenant" and args.sub == "list":
        print(json.dumps(_req(f"{base}/v1/tenants", token=args.token),
                         indent=1))
    elif args.cmd == "tenant" and args.sub == "set":
        body = {"name": args.name}
        if args.weight is not None:
            body["weight"] = args.weight
        if args.gpus is not None:
            body["quota_gpus"] = args.gpus
        if args.cpus is not None:
            body["quota_cpus"] = args.cpus
        if args.memory is not None:
            body["quota_memory_mb"] = args.memory
        print(json.dumps(_req(f"{base}/v1/tenants", "POST", body,
                              args.token)))


if __name__ == "__main__":  # pragma: no cover
    main()
