"""host_copy_share.fit [%]: the share of the window's call time spent
bringing each batch to the card as the pipeline's fit_chunk does it (the
subints stacked on the host, then copied), host clock.  Nothing to read
where the batches sit on the card already."""


def read(ctx):
    copy = [a["copy_s"] for a in ctx.entry.answers[:len(ctx.calls)]]
    if not any(copy):
        return None
    return 100.0 * sum(copy) / sum(e - s for s, e, _ in ctx.calls)
