"""End-to-end eval-CLI run on the trained fixture (twin of the reference's
tools/eval_trained.py).

Real benchmark datasets cannot be downloaded, so this drives the port's
`cli.humaneval` and `cli.mmlu` end to end on datasets the trained fixture
(cli/train_fixture.py) can answer:

  * HumanEval-style: prompts cut from the corpus code blocks the fixture
    was trained on (quicksort / RingBuffer.push). The model memorized the
    corpus, so greedy completion reproduces working code and `--exec`
    scores a real pass@1 through the execute-and-check scoring path.
  * MMLU-style: 4-option questions in the A/B/C/D format. The byte-level
    corpus LM has never seen the format, so chance (~25%) is the honest
    expectation; the row records the driven pipeline, not the score.

Writes its JSON to `--out` (default build/eval_trained.json); the
reference writes docs/sessions/r5_eval_trained.json and takes no flags.

    python -m exllamav2_tpu_torch.cli.eval_trained [-m <model_dir>]
        [--out build/eval_trained.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import io
import json
import os
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "trained_tiny")

HUMANEVAL_PROBLEMS = [
    {
        "task_id": "Corpus/quicksort",
        "prompt": "def quicksort(items):\n    if len(items) <= 1:\n",
        "test": ("def check(f):\n"
                 "    assert f([3, 1, 2]) == [1, 2, 3]\n"
                 "    assert f([]) == []\n"
                 "    assert f([5, 5, 1]) == [1, 5, 5]\n"),
        "entry_point": "quicksort",
    },
    {
        # fuller prefix: the three near-identical comprehension lines are
        # the one place greedy decode can legitimately fork; giving them
        # in the prompt leaves the unambiguous tail to complete
        "task_id": "Corpus/quicksort_tail",
        "prompt": ("def quicksort(items):\n"
                   "    if len(items) <= 1:\n        return items\n"
                   "    pivot = items[len(items) // 2]\n"
                   "    left = [x for x in items if x < pivot]\n"
                   "    mid = [x for x in items if x == pivot]\n"),
        "test": ("def check(f):\n"
                 "    assert f([3, 1, 2]) == [1, 2, 3]\n"
                 "    assert f([9, 2, 7, 2]) == [2, 2, 7, 9]\n"),
        "entry_point": "quicksort",
    },
    {
        "task_id": "Corpus/ringbuffer_push",
        "prompt": ("class RingBuffer:\n"
                   "    def __init__(self, capacity: int):\n"
                   "        self.data = [None] * capacity\n"
                   "        self.head = 0\n"
                   "        self.size = 0\n\n"
                   "    def push(self, value):\n"),
        "test": ("def check(cls):\n"
                 "    rb = cls(2)\n"
                 "    rb.push(1); rb.push(2); rb.push(3)\n"
                 "    assert rb.size == 2\n"),
        "entry_point": "RingBuffer",
    },
]

MMLU_ROWS = [
    ["What did the keeper write in the ledger?", "the date", "a poem",
     "a recipe", "nothing", "A"],
    ["How many crates of salt are on the manifest?", "twelve", "forty",
     "seven", "none", "B"],
    ["What does the mitochondrion produce?", "DNA", "chlorophyll",
     "ATP", "keratin", "C"],
    ["What does a transformer layer apply first?", "pooling",
     "self-attention", "dropout", "convolution", "B"],
    ["At what pH were the tracing experiments run?", "7.4", "2.0",
     "11.0", "5.5", "A"],
    ["What increases surface area in the inner membrane?", "villi",
     "axons", "cristae", "alveoli", "C"],
    ["How many bits per value does the example quantization use?",
     "two", "sixteen", "eight", "four", "D"],
    ["What had gone quiet before the fog?", "the bells", "the gulls",
     "the engines", "the dogs", "B"],
]


def run_cli(main, argv) -> str:
    """A twin's main(argv) with its stdout captured, echoed -> the text."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out = buf.getvalue()
    print(out)
    return out


def main(argv=None) -> dict:
    """-> the JSON it writes: the model, the humaneval completions and
    pass@1 line, the mmlu accuracy line."""
    from exllamav2_tpu_torch.cli import humaneval, mmlu
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model_dir", default=FIXTURE)
    ap.add_argument("--out", default=os.path.join("build",
                                                  "eval_trained.json"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)
    assert os.path.exists(os.path.join(args.model_dir, "config.json")), \
        "train the fixture first: python -m " \
        "exllamav2_tpu_torch.cli.train_fixture"
    dev = [] if args.device is None else ["--device", args.device]
    res = {"model": args.model_dir,
           "trainer": "exllamav2_tpu_torch/cli/train_fixture.py"}
    with tempfile.TemporaryDirectory(prefix="eval_trained_") as tmp:
        he = os.path.join(tmp, "humaneval.jsonl")
        with open(he, "w") as f:
            for p in HUMANEVAL_PROBLEMS:
                f.write(json.dumps(p) + "\n")
        he_out = os.path.join(tmp, "he_out.jsonl")
        out = run_cli(humaneval.main,
                      ["-m", args.model_dir, "-d", he, "-o", he_out,
                       "--max_tokens", "220", "-l", "1024", "--exec"] + dev)
        res["humaneval"] = {
            "problems": len(HUMANEVAL_PROBLEMS),
            "stdout_tail": out.strip().splitlines()[-2:],
        }
        for line in out.splitlines():
            if "pass@1" in line:
                res["humaneval"]["pass_at_1"] = line.strip()
        with open(he_out) as f:
            res["humaneval"]["completions"] = [
                json.loads(l) for l in f.read().splitlines()]

        ds = os.path.join(tmp, "mmlu")
        os.makedirs(ds)
        with open(os.path.join(ds, "corpus_test.csv"), "w",
                  newline="") as f:
            csv.writer(f).writerows(MMLU_ROWS)
        out = run_cli(mmlu.main, ["-m", args.model_dir, "-d", ds, "-fs",
                                  "2", "-l", "1024"] + dev)
        res["mmlu"] = {"stdout_tail": out.strip().splitlines()[-2:]}
        for line in out.splitlines():
            if "accuracy" in line:
                res["mmlu"]["accuracy_line"] = line.strip()

    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
