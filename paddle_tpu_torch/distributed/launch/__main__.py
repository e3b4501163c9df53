from . import main

# run as `python -m paddle_tpu_torch.distributed.launch`; importing the
# module (a walk of the package) starts nothing
if __name__ == "__main__":
    main()
