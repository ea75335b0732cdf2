"""``python -m point_cloud_classifier_tpu_torch <command> …``: the command line
(``cli.py``), on the card."""

from point_cloud_classifier_tpu_torch.cli import main

if __name__ == "__main__":
    main()
