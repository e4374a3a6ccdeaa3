"""Prompt plus generated tokens of the requests the member answered, over
the window of whole batches: from the dispatch of the first batch to the
end of the last batch that ends within the window's seconds (the frontend
returns a batch's answers together)."""

from vsrbench.readers import prompt_tokens, served


def read(run):
    batches = run.window_batches()
    if not batches:
        return None
    idx = {i for b in batches for i in b.indices}
    recs = served(run.requests[i] for i in idx if i in run.requests)
    tokens = sum(prompt_tokens(run, r) + int(r.usage.get(
        "completion_tokens", 0)) for r in recs)
    span = batches[-1].end - batches[0].start
    return tokens / span if span > 0 and tokens else None
