"""Traffic kinds: each module generates one kind of traffic from the seed
and drives the program with it (benchmark/spec.py finds a kind by the
"kind" of a traffic file).  Each defines a Loop with

    Loop(cfg, ref_cfg, traffic, seed, device)  set-up: inputs, warm-up
    call(i) -> (attempted, failed)   one call, its answers on the host
    stats() -> dict                  numbers for the metric readers
    release()                        drop the program's state
    check() -> {number: value}       the sample against the reference
    control(dtype) -> {number: value}  the same check of the reference
                                     run in `dtype` in the program's place
"""
