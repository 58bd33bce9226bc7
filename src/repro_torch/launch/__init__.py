"""Entry points of the port: serving
(``python -m repro_torch.launch.serve``) and federated LM fine-tuning
(``python -m repro_torch.launch.train``)."""
