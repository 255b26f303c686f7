"""Continuous-batching serving engine of the PyTorch port.

    from repro_torch.runtime.batching import BatchingEngine

    engine = BatchingEngine(session, max_batch=8)       # or a supervisor
    stream = engine.submit(prompt_tokens, gen_len=16)   # returns instantly
    engine.step()            # one decode-step boundary (admit + decode)
    for tok in stream: ...   # tokens arrive as the loop runs
    stream.result()          # the full int32 token array (done-future)

Requests join and retire mid-flight at decode-step boundaries; each
request's token stream is byte-identical to a solo batch-1
``session.generate`` of the same prompt over the pool's ``max_seq``
(see ``engine.py`` for why).
"""
from repro_torch.runtime.batching.engine import BatchingEngine
from repro_torch.runtime.batching.kvpool import KVPool
from repro_torch.runtime.batching.scheduler import FCFSScheduler, Request
from repro_torch.runtime.batching.streams import StreamCancelled, StreamHandle

__all__ = ["BatchingEngine", "KVPool", "FCFSScheduler", "Request",
           "StreamHandle", "StreamCancelled"]
