"""Runtime services the serving engine uses: straggler detection,
heartbeats and deterministic fault injection."""
