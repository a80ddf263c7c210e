"""Host ms per batch from entering the program's engine entry to its
return (the harness's `engine` span), over the traced window: the entry's
issue work and its host syncs."""


def read(ctx):
    spans = [b["engine"] for b in ctx.record.window if "engine" in b]
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
