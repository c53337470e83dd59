"""EXL2 conversion CLI of the port (the counterpart of the root convert.py).

Usage:
    python -m exllamav2_tpu_torch.convert -i <fp16_model_dir> -o <out_dir>
        -b 4.0 [-hb 8] [-c calibration.txt] [-r rows] [-l row_len]
        [--device cuda|cpu]

Runs on the card by default (the GPTQ row recursion is kernel G1,
csrc/gptq.cu); --device cpu runs every step on the CPU.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="Convert a model to EXL2")
    ap.add_argument("-i", "--in_dir", required=True)
    ap.add_argument("-o", "--out_dir", required=True)
    ap.add_argument("-b", "--bits", type=float, default=4.0,
                    help="target average bits per weight")
    ap.add_argument("-hb", "--head_bits", type=int, default=8)
    ap.add_argument("-c", "--cal_dataset", default=None,
                    help="calibration data: .txt or .parquet file")
    ap.add_argument("-r", "--rows", type=int, default=16)
    ap.add_argument("-l", "--length", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-ss", "--output_shard_size", type=float, default=8192,
                    help="split output above this many MB into numbered "
                         "safetensors shards + index (0 = single file)")
    ap.add_argument("--status_output", action="store_true",
                    help="emit [STATUS]{...}[/STATUS] machine-parseable "
                         "stage lines")
    ap.add_argument("-gs", "--group_size", type=int, default=32,
                    help="scale-group rows for every candidate option "
                         "(default 32; 128 emits the coarser groups of the "
                         "W4A8 decode mode)")
    ap.add_argument("--device", default="cuda",
                    help="device to convert on (default cuda; cpu runs the "
                         "plain versions)")
    args = ap.parse_args(argv)

    from exllamav2_tpu_torch.convert.pipeline import convert_model
    convert_model(args.in_dir, args.out_dir, bits=args.bits,
                  head_bits=args.head_bits, cal_rows=args.rows,
                  cal_len=args.length, cal_text=args.cal_dataset,
                  seed=args.seed, shard_size_mb=args.output_shard_size,
                  status_output=args.status_output,
                  group_size=args.group_size, device=args.device)


if __name__ == "__main__":
    main()
