import sys

from deeplearning4j_tpu_torch.analysis.cli import main

sys.exit(main())
