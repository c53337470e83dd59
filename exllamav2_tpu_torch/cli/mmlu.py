"""MMLU evaluation through the dynamic generator (twin of the reference's
eval/mmlu.py).

4-option multiple-choice questions queued as jobs, answered by the greedy
next token compared with the A/B/C/D pieces. The dataset is a directory of
csv files (cais/mmlu layout), or a local Hugging Face ``datasets`` path
where that package is installed.

    python -m exllamav2_tpu_torch.cli.mmlu -m <model_dir> -d <csv_dir> [-fs 5]
"""

import argparse
import os

from exllamav2_tpu_torch import model_init


def format_question(q, choices, answer_idx=None, include_answer=False):
    s = q + "\n"
    for i, c in enumerate(choices):
        s += f"{'ABCD'[i]}. {c}\n"
    s += "Answer:"
    if include_answer:
        s += f" {'ABCD'[answer_idx]}\n\n"
    return s


def load_rows(path: str, subject: str | None):
    """Rows of (question, choices, answer) from a csv dir or datasets dir."""
    rows = []
    if os.path.isdir(path):
        import csv
        for fn in sorted(os.listdir(path)):
            if not fn.endswith(".csv"):
                continue
            if subject and subject not in fn:
                continue
            with open(os.path.join(path, fn)) as f:
                for r in csv.reader(f):
                    rows.append((r[0], r[1:5], "ABCD".index(r[5])))
    else:
        try:
            from datasets import load_dataset
        except ImportError as e:
            raise ImportError(
                f"{path!r} is not a directory of csv files, and reading it "
                "as a Hugging Face dataset needs the `datasets` package, "
                "which is not installed") from e
        ds = load_dataset(path, subject or "all", split="test")
        for r in ds:
            rows.append((r["question"], r["choices"], int(r["answer"])))
    return rows


def main(argv=None) -> dict:
    """-> {"accuracy", "total", "picks" (one index or -1 a question),
    "prompts"}."""
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    ap.add_argument("-d", "--dataset", required=True,
                    help="MMLU csv directory or local datasets path")
    ap.add_argument("-sub", "--subject", default=None)
    ap.add_argument("-fs", "--fewshot", type=int, default=5)
    ap.add_argument("-n", "--num_questions", type=int, default=0)
    args = ap.parse_args(argv)

    model, tokenizer, generator = model_init.init(args, max_batch_size=16)
    rows = load_rows(args.dataset, args.subject)
    if args.num_questions:
        rows = rows[:args.num_questions]
    fewshot = "".join(format_question(q, c, a, True)
                      for q, c, a in rows[:args.fewshot])
    eval_rows = rows[args.fewshot:]

    letter_ids = [int(tokenizer.encode(" " + l)[-1]) for l in "ABCD"]

    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    from exllamav2_tpu_torch.generator.sampler import Settings

    correct = total = 0
    picks, prompts = [], []
    for q, choices, answer in eval_rows:
        prompt = fewshot + format_question(q, choices)
        job = generator.enqueue(DynamicJob(
            tokenizer.encode(prompt), max_new_tokens=1,
            settings=Settings.greedy()))
        while job.status != "done":
            generator.iterate()
        tok = int(job.sequence[-1])
        pred = letter_ids.index(tok) if tok in letter_ids else -1
        correct += int(pred == answer)
        total += 1
        picks.append(pred)
        prompts.append(prompt)
        print(f"  {correct}/{total} ({100 * correct / max(total, 1):.2f}%)",
              end="\r")
    accuracy = 100 * correct / max(total, 1)
    print(f"\n -- accuracy: {accuracy:.2f}% on {total} questions")
    return {"accuracy": accuracy, "total": total, "picks": picks,
            "prompts": prompts}


if __name__ == "__main__":
    main()
