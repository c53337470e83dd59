"""Run the websocket inference server (twin of the reference's
examples/ws_server.py). Needs the `websockets` package.

    python -m exllamav2_tpu_torch.cli.ws_server -m <model_dir> [--port 7862]

Connect with ws://localhost:7862 and send
  {"action": "infer", "text": "Hello", "max_new_tokens": 64}
"""

import argparse

from exllamav2_tpu_torch import model_init
from exllamav2_tpu_torch.server.websocket import WebSocketServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    ap.add_argument("--port", type=int, default=7862)
    args = ap.parse_args(argv)

    model, tokenizer, generator = model_init.init(args)
    server = WebSocketServer(generator, port=args.port)
    print(f" -- serving on ws://0.0.0.0:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
