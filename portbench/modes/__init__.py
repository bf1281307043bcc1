"""Traffic modes, one module each, found by the name a mix's file gives
under "mode"; each module's `Session(config, traffic, seed, device, torch)`
does a cell's set-up, queues its frames (`step`) and judges them."""
