from particlesimulation_tpu_torch.cli import main

raise SystemExit(main())
