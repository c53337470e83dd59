"""Console chat (twin of the reference's examples/chat.py, the reference
examples/chat.py + chat_prompts.py analog).

Prompt formats: raw / llama / llama3 / chatml / mistral / gemma / phi3 /
cohere / granite / deepseek and more. Streams tokens as they generate.

Turn-based context management that drops the OLDEST turns when the context
fills (keeping the system prompt), the full sampler surface (DRY / XTC /
smoothing / dynamic temperature / typical / skew ...), draft-model and
n-gram speculative decoding, multi-line input, per-response timings,
amnesia mode, and special-token prompt encoding for formats whose markers
are control tokens. Reads the user's turns from standard input.

    python -m exllamav2_tpu_torch.cli.chat -m <model_dir> -mode llama3
    python -m exllamav2_tpu_torch.cli.chat -modes          # list formats
"""

import argparse
import time

import numpy as np

from exllamav2_tpu_torch import model_init

PROMPT_FORMATS = {
    "raw": {
        "description": "bare {user}/{bot} dialogue, no special tokens",
        "system": "{system}\n",
        "turn": "{username}: {user}\n{botname}:",
        "stop": ["{username}:"],
        "turn_end": "\n",
    },
    "llama3": {
        "description": "Llama-3 instruct header tokens",
        "system": "<|begin_of_text|><|start_header_id|>system"
                  "<|end_header_id|>\n\n{system}<|eot_id|>",
        "turn": "<|start_header_id|>user<|end_header_id|>\n\n{user}"
                "<|eot_id|><|start_header_id|>assistant"
                "<|end_header_id|>\n\n",
        "stop": ["<|eot_id|>"],
        "turn_end": "<|eot_id|>",
        "special": True,
    },
    "chatml": {
        "description": "ChatML (<|im_start|> markers): Qwen, Yi, ...",
        "system": "<|im_start|>system\n{system}<|im_end|>\n",
        "turn": "<|im_start|>user\n{user}<|im_end|>\n"
                "<|im_start|>assistant\n",
        "stop": ["<|im_end|>"],
        "turn_end": "<|im_end|>\n",
        "special": True,
    },
    "llama": {                       # llama-2 [INST] style: the system
        "description": "Llama-2 [INST] <<SYS>> blocks",
        "system": "",                # prompt folds into the first [INST]
        "first_turn": "[INST] <<SYS>>\n{system}\n<</SYS>>\n\n"
                      "{user} [/INST]",
        "turn": "[INST] {user} [/INST]",
        "stop": ["[INST]"],
        "turn_end": " ",
    },
    "mistral": {
        "description": "Mistral-instruct [INST] blocks",
        "system": "<s>",
        "turn": "[INST] {user} [/INST]",
        "stop": ["[INST]", "</s>"],
        "turn_end": "</s>",
        "special": True,
    },
    "gemma": {
        "description": "Gemma start_of_turn dialogue (no system role)",
        "system": "<bos>",
        "turn": "<start_of_turn>user\n{user}<end_of_turn>\n"
                "<start_of_turn>model\n",
        "stop": ["<end_of_turn>"],
        "turn_end": "<end_of_turn>\n",
        "special": True,
    },
    "phi3": {
        "description": "Phi-3 <|user|>/<|assistant|> markers",
        "system": "<|system|>\n{system}<|end|>\n",
        "turn": "<|user|>\n{user}<|end|>\n<|assistant|>\n",
        "stop": ["<|end|>"],
        "turn_end": "<|end|>\n",
        "special": True,
    },
    "cohere": {
        "description": "Command-R turn tokens",
        "system": "<BOS_TOKEN><|START_OF_TURN_TOKEN|><|SYSTEM_TOKEN|>"
                  "{system}<|END_OF_TURN_TOKEN|>",
        "turn": "<|START_OF_TURN_TOKEN|><|USER_TOKEN|>{user}"
                "<|END_OF_TURN_TOKEN|><|START_OF_TURN_TOKEN|>"
                "<|CHATBOT_TOKEN|>",
        "stop": ["<|END_OF_TURN_TOKEN|>"],
        "turn_end": "<|END_OF_TURN_TOKEN|>",
        "special": True,
    },
    "granite": {
        "description": "Granite System/Question/Answer blocks",
        "system": "System:\n{system}\n\n",
        "turn": "Question:\n{user}\n\nAnswer:\n",
        "stop": ["Question:"],
        "turn_end": "\n\n",
    },
    "deepseek": {
        "description": "DeepSeek User/Assistant dialogue",
        "system": "{system}\n\n",
        "turn": "User: {user}\n\nAssistant:",
        "stop": ["User:"],
        "turn_end": "\n\n",
    },
    "codellama": {                   # llama-2 [INST] with a coding persona
        "description": "CodeLlama-instruct ([INST] + coding system prompt)",
        "system": "",
        "first_turn": "[INST] <<SYS>>\n{system}\n<</SYS>>\n\n"
                      "{user} [/INST]",
        "turn": "[INST] {user} [/INST]",
        "stop": ["[INST]"],
        "turn_end": " ",
        "default_system": "You are a helpful coding assistant. Always "
                          "answer as helpfully as possible.",
    },
    "qwq": {
        "description": "Qwen QwQ (ChatML + <think> reasoning opener)",
        "system": "<|im_start|>system\n{system}<|im_end|>\n",
        "turn": "<|im_start|>user\n{user}<|im_end|>\n"
                "<|im_start|>assistant\n<think>\n",
        "stop": ["<|im_end|>"],
        "turn_end": "<|im_end|>\n",
        "special": True,
        "default_system": "You are a useful coding assistant, who thinks "
                          "before answering.",
    },
    "zephyr": {
        "description": "Zephyr <|user|>/<|assistant|> + </s> turns",
        "system": "<|system|>\n{system}\n</s>\n",
        "turn": "<|user|>\n{user}</s>\n<|assistant|>\n",
        "stop": ["<|user|>", "</s>"],
        "turn_end": "</s>\n",
        "special": True,
    },
    "solar": {
        "description": "Solar-instruct ### User/Assistant blocks",
        "system": "### System\n{system}\n\n",
        "turn": "### User:\n{user}\n\n### Assistant:\n",
        "stop": ["\n\n### User", "\n### User"],
        "turn_end": "\n\n",
    },
    "openchat": {
        "description": "OpenChat GPT4-Correct turns",
        "system": "{system}<|end_of_turn|>",
        "turn": "GPT4 Correct User:{user}<|end_of_turn|>"
                "GPT4 Correct Assistant:",
        "stop": ["<|end_of_turn|>", "<|endoftext|>", "GPT4 Correct User:"],
        "turn_end": "<|end_of_turn|>",
        "special": True,
    },
    "nous": {
        "description": "Nous Research USER:/ASSISTANT: blocks",
        "system": "{system}\n\n",
        "turn": "USER:\n{user}\n\nASSISTANT:\n",
        "stop": ["</s>", "USER:"],
        "turn_end": "\n\n",
        "default_system": "Perform the task to the best of your ability.",
    },
    "granite3": {
        "description": "Granite-3 start_of_role turns",
        "system": "<|start_of_role|>system<|end_of_role|>{system}"
                  "<|end_of_text|>",
        "turn": "<|start_of_role|>user<|end_of_role|>{user}"
                "<|end_of_text|><|start_of_role|>assistant"
                "<|end_of_role|>",
        "stop": ["<|end_of_text|>"],
        "turn_end": "<|end_of_text|>",
        "special": True,
        "default_system": "You are Granite, developed by IBM. You are a "
                          "helpful AI assistant.",
    },
    "glm": {
        "description": "GLM-4 [gMASK]<sop> + role markers",
        "system": "[gMASK]<sop><|system|>\n{system}",
        "turn": "<|user|>\n{user}<|assistant|>\n",
        "stop": ["<|user|>"],
        "turn_end": "",
        "special": True,
    },
}


def build_settings(args):
    from exllamav2_tpu_torch.generator.sampler import Settings
    s = Settings(
        temperature=args.temperature,
        smoothing_factor=args.smoothing_factor,
        top_k=args.top_k, top_p=args.top_p, top_a=args.top_a,
        typical=args.typical, skew=args.skew,
        token_repetition_penalty=args.repetition_penalty,
        token_frequency_penalty=args.frequency_penalty,
        token_presence_penalty=args.presence_penalty,
        xtc_probability=args.xtc_probability,
        xtc_threshold=args.xtc_threshold,
        dry_multiplier=args.dry_multiplier,
        dry_allowed_length=args.dry_allowed_length,
        dry_base=args.dry_base, dry_range=args.dry_range,
    )
    if args.dynamic_temperature:
        lo, hi, exp = (float(v) for v in
                       args.dynamic_temperature.split(","))
        s.min_temp, s.max_temp, s.temp_exponent = lo, hi, exp
    return s


def read_user_input(multiline: bool) -> str:
    if not multiline:
        return input("\nYou: ")
    print("\nYou (end with a line containing only '.'): ")
    lines = []
    while True:
        line = input()
        if line.strip() == ".":
            break
        lines.append(line)
    return "\n".join(lines)


def main(argv=None) -> list[str]:
    """-> the replies, one a turn."""
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    ap.add_argument("-modes", action="store_true",
                    help="list available formats and exit")
    ap.add_argument("-mode", choices=list(PROMPT_FORMATS), default="raw")
    ap.add_argument("-un", "--username", default="User")
    ap.add_argument("-bn", "--botname", default="Assistant")
    ap.add_argument("-sp", "--system_prompt",
                    default="You are a helpful assistant.")
    ap.add_argument("-nsp", "--no_system_prompt", action="store_true")
    ap.add_argument("-temp", "--temperature", type=float, default=0.8)
    ap.add_argument("-smooth", "--smoothing_factor", type=float, default=0.0)
    ap.add_argument("-dyntemp", "--dynamic_temperature", default=None,
                    help="min,max,exponent")
    ap.add_argument("-topk", "--top_k", type=int, default=50)
    ap.add_argument("-topp", "--top_p", type=float, default=0.8)
    ap.add_argument("-topa", "--top_a", type=float, default=0.0)
    ap.add_argument("-typical", type=float, default=0.0)
    ap.add_argument("-skew", type=float, default=0.0)
    ap.add_argument("-repp", "--repetition_penalty", type=float,
                    default=1.05)
    ap.add_argument("-freqpen", "--frequency_penalty", type=float,
                    default=0.0)
    ap.add_argument("-prespen", "--presence_penalty", type=float,
                    default=0.0)
    ap.add_argument("-xtcp", "--xtc_probability", type=float, default=0.0)
    ap.add_argument("-xtct", "--xtc_threshold", type=float, default=0.1)
    ap.add_argument("-drym", "--dry_multiplier", type=float, default=0.0)
    ap.add_argument("-drya", "--dry_allowed_length", type=int, default=2)
    ap.add_argument("-dryb", "--dry_base", type=float, default=1.75)
    ap.add_argument("-dryr", "--dry_range", type=int, default=0)
    ap.add_argument("-maxr", "--max_response_tokens", type=int, default=512)
    ap.add_argument("-resc", "--response_chunk", type=int, default=250,
                    help="context space reserved for the reply")
    ap.add_argument("-dm", "--draft_model_dir", default=None)
    ap.add_argument("-dn", "--draft_n_tokens", type=int, default=4)
    ap.add_argument("-ngram", "--ngram_decoding", action="store_true")
    ap.add_argument("-mli", action="store_true", help="multi-line input")
    ap.add_argument("-pt", "--print_timings", action="store_true")
    ap.add_argument("-amnesia", action="store_true",
                    help="forget context after every response")
    args, _ = ap.parse_known_args(argv)

    if args.modes:
        print(" -- Available formats:")
        for k, v in PROMPT_FORMATS.items():
            print(f" --   {k:10} : {v['description']}")
        return []

    model, tokenizer, generator = model_init.init(
        args, draft_model_dir=args.draft_model_dir,
        num_draft_tokens=args.draft_n_tokens,
        use_ngram_draft=args.ngram_decoding)
    fmt = PROMPT_FORMATS[args.mode]
    special = bool(fmt.get("special"))
    if args.no_system_prompt:
        system_prompt = ""
    elif args.system_prompt == ap.get_default("system_prompt"):
        # format-specific default persona unless the user overrode it
        system_prompt = fmt.get("default_system", args.system_prompt)
    else:
        system_prompt = args.system_prompt

    def render(tpl, user=""):
        return (tpl.replace("{username}", args.username)
                .replace("{botname}", args.botname)
                .replace("{system}", system_prompt)
                .replace("{user}", user))

    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    settings = build_settings(args)
    stops = [render(s) for s in fmt["stop"]]
    max_ctx = generator.max_seq_len - args.response_chunk

    def encode(text):
        return tokenizer.encode(text, encode_special_tokens=special)

    system_text = render(fmt["system"])
    turns: list[tuple[str, str]] = []    # (user_text, bot_text)
    replies: list[str] = []

    def context_ids():
        """system + newest turns that fit in max_ctx tokens (reference
        get_tokenized_context: drop the OLDEST turns first)."""
        sys_ids = encode(system_text)
        kept, total = [], len(sys_ids)
        for i, (u, b) in enumerate(reversed(turns)):
            first = (len(turns) - 1 - i) == 0
            tpl = fmt.get("first_turn", fmt["turn"]) if first \
                else fmt["turn"]
            ids = encode(render(tpl, user=u) + b)
            if total + len(ids) > max_ctx and kept:
                break
            total += len(ids)
            kept.append(ids)
        return np.concatenate([sys_ids] + kept[::-1]) if kept else sys_ids

    print(" -- chat ready; Ctrl-C to exit"
          + (" ('.' line ends multi-line input)" if args.mli else ""))
    while True:
        try:
            user = read_user_input(args.mli)
        except (KeyboardInterrupt, EOFError):
            print()
            break
        turns.append((user, ""))
        job = generator.enqueue(DynamicJob(
            context_ids(), max_new_tokens=args.max_response_tokens,
            settings=settings, stop_conditions=list(stops)))
        print(f"{args.botname}: ", end="", flush=True)
        reply = ""
        t0 = time.perf_counter()
        # chat runs one job at a time, so filtering the results by its
        # serial drops nothing
        while job.status != "done":
            for r in generator.iterate():
                if r.get("serial") == id(job):
                    chunk = r.get("text", "")
                    reply += chunk
                    print(chunk, end="", flush=True)
        print()
        replies.append(reply)
        if args.print_timings:
            dt = max(time.perf_counter() - t0, 1e-9)
            print(f" -- {job.new_tokens} tokens, "
                  f"{job.new_tokens / dt:.1f} t/s, "
                  f"prompt {job.prompt_len} tokens")
        if args.amnesia:
            turns.clear()
        else:
            # close the bot turn with the format's end-of-turn string —
            # NOT stops[0], which for raw/[INST]/QA formats is the NEXT
            # turn's opening marker and would duplicate it in the rebuilt
            # context (the turn template re-renders it)
            turns[-1] = (user, reply + render(fmt.get("turn_end", "")))
    return replies


if __name__ == "__main__":
    main()
