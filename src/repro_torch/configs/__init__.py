from .paper_tasks import PAPER_TASKS, SYNTHETIC, PaperTask
