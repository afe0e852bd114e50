"""The IRC object detector (`detector`) and the language-model zoo
(`transformer.LM` over `lm_config.LMConfig`: dense / GQA / sliding-window /
softcap / MoE / hybrid-SSM / RWKV6)."""
