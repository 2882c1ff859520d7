from .thread_group import TaskClass, TaskComposer, TaskGroup, ThreadGroup
