"""``BatchScheduler.submit``: the continuous-batching scheduler over the
engine, with the mix's ``entry`` settings (``max_batch``, ...) as its
keywords. The set-up runs the scheduler's own warm-up for the longest
prompt and answer the plan holds."""


class Server:
    def __init__(self, engine, settings: dict):
        from fastvlm_tpu_torch.serve.batcher import BatchScheduler

        self.engine = engine
        self.sched = BatchScheduler(engine, **settings)

    def stream(self, req, images):
        from fastvlm_tpu_torch.ops.sampling import SamplingParams

        return self.sched.submit(req.prompt, images[req.image],
                                 max_new_tokens=req.max_new,
                                 sampling=SamplingParams(**req.sampling))

    def warm(self, prompt_len: int, max_new_tokens: int) -> None:
        self.sched.warmup(prompt_len=prompt_len,
                          max_new_tokens=max_new_tokens)

    def counters(self) -> dict:
        return dict(self.sched.counters)

    def close(self) -> None:
        self.sched.shutdown()


def build(engine, settings: dict) -> Server:
    return Server(engine, settings)
