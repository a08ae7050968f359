from map_oxidize_tpu_torch.cli import main

raise SystemExit(main())
