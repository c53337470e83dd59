"""HumanEval pass@k evaluation through the dynamic generator (twin of the
reference's eval/humaneval.py).

Queues every problem x samples as concurrent jobs (continuous batching),
collects the completions, optionally executes the checks. Needs the
HumanEval jsonl as a local file.

    python -m exllamav2_tpu_torch.cli.humaneval -m <model_dir> -d HumanEval.jsonl
"""

import argparse
import json

from exllamav2_tpu_torch import model_init

# a completion ends where the next top-level statement would begin
STOP_CONDITIONS = ["\ndef ", "\nclass ", "\nif ", "\nprint"]


def main(argv=None) -> dict:
    """-> {"completions": [(task_id, completion)], "pass@1" (with
    --exec)}."""
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    ap.add_argument("-d", "--dataset", required=True,
                    help="HumanEval.jsonl path")
    ap.add_argument("-spp", "--samples_per_problem", type=int, default=1)
    ap.add_argument("-o", "--output", default="humaneval_output.jsonl")
    ap.add_argument("--max_tokens", type=int, default=384)
    ap.add_argument("--exec", dest="run_exec", action="store_true",
                    help="execute generated code against the checks "
                         "(runs untrusted model output!)")
    args = ap.parse_args(argv)

    model, tokenizer, generator = model_init.init(args, max_batch_size=16)
    problems = []
    with open(args.dataset) as f:
        for line in f:
            if line.strip():
                problems.append(json.loads(line))

    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    from exllamav2_tpu_torch.generator.sampler import Settings

    s = Settings(temperature=0.6, top_p=0.9) \
        if args.samples_per_problem > 1 else Settings.greedy()
    jobs = {}
    for p in problems:
        for k in range(args.samples_per_problem):
            job = generator.enqueue(DynamicJob(
                tokenizer.encode(p["prompt"]),
                max_new_tokens=args.max_tokens, settings=s, seed=k,
                stop_conditions=list(STOP_CONDITIONS)))
            jobs[id(job)] = (p, job)

    done = 0
    while any(j.status != "done" for _, j in jobs.values()):
        for r in generator.iterate():
            if r.get("eos"):
                done += 1
                print(f"  {done}/{len(jobs)}", end="\r")

    passed = total = 0
    out = {"completions": []}
    with open(args.output, "w") as f:
        for p, job in jobs.values():
            completion = job.emitted_text
            out["completions"].append((p["task_id"], completion))
            f.write(json.dumps({"task_id": p["task_id"],
                                "completion": completion}) + "\n")
            if args.run_exec:
                program = p["prompt"] + completion + "\n" + p["test"] + \
                    f"\ncheck({p['entry_point']})\n"
                total += 1
                try:
                    g = {}
                    exec(program, g)        # noqa: S102 - explicit opt-in
                    passed += 1
                except Exception:
                    pass
    print(f"\n -- wrote {args.output}")
    if args.run_exec:
        out["pass@1"] = 100 * passed / max(total, 1)
        print(f" -- pass@1: {out['pass@1']:.1f}%")
    return out


if __name__ == "__main__":
    main()
