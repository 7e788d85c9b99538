from .synthetic import (lm_batch_iterator, synthetic_lm_batch,
                        synthetic_tokens)
