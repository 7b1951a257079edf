"""Traffic drivers, one a kind: `warm(ctx)` runs every shape the traffic
uses; `run(ctx, seconds, span)` drives the window and returns a
`Window`. A traffic file names its driver."""
