"""capture_launches_per_s: tracking-kernel launches per second of signal
over the window, from the port's exact launch counters
(`ops.chunk_corr.launches`, `ops.track_chain.launches`,
`ops.gather_block.launches`)."""


def read(run):
    n = sum(run.launches.values())
    return n / run.signal_s if n and run.signal_s > 0 else None
