from kubernetesnetawarescheduler_tpu_torch.serve import main

if __name__ == "__main__":
    raise SystemExit(main())
