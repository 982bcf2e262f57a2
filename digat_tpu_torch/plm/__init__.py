"""Pretrained language models behind the SAG miner (`plm.mpnet`)."""
