"""Simple batch generator (PyTorch port of exllamav2_tpu/generator/base.py):
synchronous full-batch generate_simple over the dynamic generator."""

from __future__ import annotations

from exllamav2_tpu_torch.generator.sampler import Settings

__all__ = ["BaseGenerator"]


class BaseGenerator:
    """Non-streaming batch generation, a thin wrapper of DynamicGenerator."""

    def __init__(self, model, cache, tokenizer):
        from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator
        if isinstance(model, DynamicGenerator):
            self.generator = model
        else:
            self.generator = DynamicGenerator(model, cache, tokenizer)
        self.tokenizer = self.generator.tokenizer

    def generate_simple(self, prompt, gen_settings: Settings | None = None,
                        num_tokens: int = 128, seed: int | None = None,
                        token_healing: bool = False,
                        add_bos: bool = False, completion_only: bool = False,
                        stop_token: int | None = -1):
        """prompt str or list[str] -> completed text(s)."""
        single = isinstance(prompt, str)
        prompts = [prompt] if single else list(prompt)
        stop_conditions = []
        if stop_token == -1:
            eos = self.tokenizer.eos_token_id
            if eos is not None:
                stop_conditions = [eos] if isinstance(eos, int) else list(eos)
        elif stop_token is not None:
            stop_conditions = [stop_token]

        from exllamav2_tpu_torch.generator.dynamic import DynamicJob
        jobs = []
        for i, p in enumerate(prompts):
            ids = self.tokenizer.encode(p, add_bos=add_bos)
            jobs.append(self.generator.enqueue(DynamicJob(
                ids, max_new_tokens=num_tokens,
                settings=gen_settings or Settings(),
                seed=(seed or 0) + i, stop_conditions=stop_conditions,
                token_healing=token_healing)))
        while any(j.status != "done" for j in jobs):
            self.generator.iterate()
        outs = [(("" if completion_only else p) + j.emitted_text)
                for p, j in zip(prompts, jobs)]
        return outs[0] if single else outs
